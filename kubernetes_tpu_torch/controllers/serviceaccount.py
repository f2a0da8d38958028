"""ServiceAccount + token controllers.

Reference: pkg/serviceaccount/serviceaccounts_controller.go (ensure every
namespace carries a "default" ServiceAccount) and tokens_controller.go
(mint a token Secret per ServiceAccount and reference it from
sa.secrets). Wired from controllermanager.go:433-443.
"""

from __future__ import annotations

import secrets as pysecrets
import threading
from dataclasses import replace
from typing import Optional

from ..api.cache import Informer
from ..core import types as api
from ..core.errors import ApiError, NotFound

DEFAULT_SA = "default"
TOKEN_SECRET_TYPE = "kubernetes.io/service-account-token"


class ServiceAccountsController:
    """Every active namespace gets the default ServiceAccount."""

    def __init__(self, client):
        self.client = client
        self.ns_informer = Informer(
            client, "namespaces",
            on_add=self._ensure_default,
            on_update=lambda old, new: self._ensure_default(new))
        self.sa_informer = Informer(
            client, "serviceaccounts",
            on_delete=self._sa_deleted)

    def _ensure_default(self, ns: api.Namespace) -> None:
        if ns.status.phase != "Active":
            return
        try:
            self.client.get("serviceaccounts", DEFAULT_SA, ns.metadata.name)
        except NotFound:
            try:
                self.client.create("serviceaccounts", api.ServiceAccount(
                    metadata=api.ObjectMeta(name=DEFAULT_SA,
                                            namespace=ns.metadata.name)),
                    ns.metadata.name)
            except ApiError:
                pass  # raced or namespace terminating
        except ApiError:
            pass

    def _sa_deleted(self, sa: api.ServiceAccount) -> None:
        # recreate the default SA if it goes away (the reference re-syncs
        # the namespace on SA deletion)
        if sa.metadata.name != DEFAULT_SA:
            return
        try:
            ns = self.client.get("namespaces", sa.metadata.namespace)
        except (NotFound, ApiError):
            return
        self._ensure_default(ns)

    def run(self) -> "ServiceAccountsController":
        self.ns_informer.start()
        self.sa_informer.start()
        return self

    def stop(self) -> None:
        self.ns_informer.stop()
        self.sa_informer.stop()


class TokensController:
    """Mint a token Secret per ServiceAccount and link it."""

    def __init__(self, client):
        self.client = client
        self.sa_informer = Informer(
            client, "serviceaccounts",
            on_add=self._ensure_token,
            on_update=lambda old, new: self._ensure_token(new))

    def _token_name(self, sa: api.ServiceAccount) -> str:
        return f"{sa.metadata.name}-token"

    def _ensure_token(self, sa: api.ServiceAccount) -> None:
        name = self._token_name(sa)
        try:
            self.client.get("secrets", name, sa.metadata.namespace)
            have_secret = True
        except NotFound:
            have_secret = False
        except ApiError:
            return
        if not have_secret:
            secret = api.Secret(
                metadata=api.ObjectMeta(
                    name=name, namespace=sa.metadata.namespace,
                    annotations={"kubernetes.io/service-account.name":
                                 sa.metadata.name}),
                type=TOKEN_SECRET_TYPE,
                data={"token": pysecrets.token_urlsafe(32)})
            try:
                self.client.create("secrets", secret, sa.metadata.namespace)
            except ApiError:
                return
        if not any(ref.name == name for ref in sa.secrets):
            try:
                fresh = self.client.get("serviceaccounts", sa.metadata.name,
                                        sa.metadata.namespace)
                if any(ref.name == name for ref in fresh.secrets):
                    return
                self.client.update(
                    "serviceaccounts",
                    replace(fresh, secrets=list(fresh.secrets)
                            + [api.ObjectReference(kind="Secret",
                                                   name=name)]),
                    sa.metadata.namespace)
            except (NotFound, ApiError):
                pass

    def run(self) -> "TokensController":
        self.sa_informer.start()
        return self

    def stop(self) -> None:
        self.sa_informer.stop()
