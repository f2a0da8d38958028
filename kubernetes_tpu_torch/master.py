"""Master composition — one config in, a fully wired API server out.

Reference: pkg/master/master.go:279 (Master struct; resource map :575-610,
handler chain auth->authz->apis :702,710) as driven by
cmd/kube-apiserver/app/server.go:358 (APIServer.Run: admission chain
built :516-517 from the --admission-control list, auth plugins from
flags). The registry's per-resource strategies and both API groups are
installed by Registry/ApiServer themselves; this module is the one place
that composes store + admission + authn/authz + server, instead of every
caller hand-assembling them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .admission import registry_hook
from .admission.plugins import new_from_plugins
from .api.registry import Registry
from .api.server import ApiServer
from .auth.authenticate import (Authenticator, BasicAuthAuthenticator,
                                TokenAuthenticator, UnionAuthenticator)
from .auth.authorize import (AlwaysAllowAuthorizer, AlwaysDenyAuthorizer,
                             abac_from_lines)
from .core.errors import BadRequest


def _healthz_probe(port: int, host: str = "127.0.0.1"):
    def probe():
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"http://{host}:{port}/healthz", timeout=2) as resp:
                body = resp.read().decode(errors="replace").strip()
                if resp.status == 200:
                    return True, body or "ok"
                return False, f"healthz status {resp.status}: {body}"
        except Exception as e:
            return False, f"Get http://{host}:{port}/healthz: {e}"
    return probe


@dataclass
class MasterConfig:
    """(ref: master.go:157 Config + the cmd/kube-apiserver flag surface)"""
    host: str = "127.0.0.1"
    port: int = 0                      # 0 = ephemeral (tests)
    # "memory" = pure-Python Store; "native" = the C++ KV engine
    # (core/native_store.py — the external-store cost profile)
    storage_backend: str = "memory"
    # ref: --admission-control (server.go:230); plugin names as registered
    # in admission/plugins.py
    admission_control: List[str] = field(default_factory=list)
    # authn: htpasswd-style "password,user,uid" lines / token lines
    # (ref: plugin/pkg/auth/authenticator password/passwordfile, tokenfile)
    basic_auth_lines: Optional[List[str]] = None
    token_auth_lines: Optional[List[str]] = None
    # OIDC (ref: --oidc-issuer-url/--oidc-client-id, oidc.go): RS256
    # verified against a JWKS document (pure-Python PKCS#1 v1.5,
    # auth/rsa.py); oidc_hs256_secret adds the local-IdP HS256 mode
    oidc_jwks: Optional[dict] = None
    oidc_issuer: str = ""
    oidc_client_id: str = ""
    oidc_username_claim: str = "sub"
    oidc_groups_claim: str = "groups"
    oidc_hs256_secret: Optional[bytes] = None
    # ref: --experimental-keystone-url (keystone.go): basic-auth
    # delegated to a keystone-v2-shaped endpoint
    keystone_url: str = ""
    # ref: master.go tunneler wiring (--ssh-user/--ssh-keyfile enable
    # the SSH tunneler there): master->node traffic rides maintained
    # tunnels, with a healthz gate on tunnel-sync age
    enable_tunneler: bool = False
    # authz: AlwaysAllow | AlwaysDeny | ABAC (ref: --authorization-mode)
    authorization_mode: str = "AlwaysAllow"
    authorization_policy_lines: Optional[List[str]] = None
    service_cidr: str = "10.0.0.0/24"  # ref: --service-cluster-ip-range
    max_in_flight: int = 400           # ref: --max-requests-inflight
    # secure serving (ref: --tls-cert-file/--tls-private-key-file); with
    # a client CA, x509 client-cert auth joins the authenticator union
    # (ref: --client-ca-file)
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_client_ca_file: str = ""
    # ref: --runtime-config (server.go:244): group-version / per-resource
    # on-off switches, e.g. {"apis/extensions/v1beta1": False} or
    # {"apis/extensions/v1beta1/jobs": False}; "api/all" covers every
    # version
    runtime_config: Optional[Dict[str, bool]] = None


class Master:
    """Composed control-plane head: store + registry + admission + auth +
    HTTP server. start() serves; InProcClient(master.registry) gives
    co-resident components the zero-copy path (the reference's equivalent
    is compiling into one binary next to master.New)."""

    def __init__(self, config: Optional[MasterConfig] = None):
        self.config = config or MasterConfig()
        cfg = self.config

        if cfg.storage_backend == "native":
            from .core.native_store import NativeStore
            self.store = NativeStore()
        elif cfg.storage_backend == "memory":
            self.store = None  # Registry builds its own Store
        else:
            raise BadRequest(
                f"unknown storage backend {cfg.storage_backend!r}")

        self.registry = Registry(store=self.store,
                                 service_cidr=cfg.service_cidr)
        if cfg.admission_control:
            self.registry.admission = registry_hook(
                new_from_plugins(self.registry, cfg.admission_control))

        authenticators: List[Authenticator] = []
        if cfg.tls_client_ca_file:
            from .auth.authenticate import X509Authenticator
            authenticators.append(X509Authenticator())
        if cfg.basic_auth_lines:
            authenticators.append(
                BasicAuthAuthenticator.from_lines(cfg.basic_auth_lines))
        if cfg.token_auth_lines:
            authenticators.append(
                TokenAuthenticator.from_lines(cfg.token_auth_lines))
        if cfg.keystone_url:
            from .auth.authenticate import KeystonePasswordAuthenticator
            authenticators.append(
                KeystonePasswordAuthenticator(cfg.keystone_url))
        if cfg.oidc_jwks or cfg.oidc_hs256_secret:
            from .auth.authenticate import JWTAuthenticator
            authenticators.append(JWTAuthenticator(
                secret=cfg.oidc_hs256_secret, jwks=cfg.oidc_jwks,
                issuer=cfg.oidc_issuer, audience=cfg.oidc_client_id,
                username_claim=cfg.oidc_username_claim,
                groups_claim=cfg.oidc_groups_claim))
        if not authenticators:
            authenticator = None
        elif len(authenticators) == 1:
            authenticator = authenticators[0]
        else:
            authenticator = UnionAuthenticator(authenticators)

        mode = cfg.authorization_mode
        if mode == "AlwaysAllow":
            authorizer = AlwaysAllowAuthorizer()
        elif mode == "AlwaysDeny":
            authorizer = AlwaysDenyAuthorizer()
        elif mode == "ABAC":
            authorizer = abac_from_lines(cfg.authorization_policy_lines or [])
        else:
            raise BadRequest(f"unknown authorization mode {mode!r}")

        self.server = ApiServer(self.registry, host=cfg.host, port=cfg.port,
                                max_in_flight=cfg.max_in_flight,
                                authenticator=authenticator,
                                authorizer=authorizer,
                                tls_cert_file=cfg.tls_cert_file,
                                tls_key_file=cfg.tls_key_file,
                                tls_client_ca_file=cfg.tls_client_ca_file,
                                runtime_config=cfg.runtime_config)

        # componentstatus probes at the components' conventional healthz
        # ports (ref: master.go getServersToValidate: scheduler :10251,
        # controller-manager :10252)
        from .utils.healthz import (CONTROLLER_MANAGER_PORT,
                                    SCHEDULER_PORT)
        self.registry.add_component_probe(
            "scheduler", _healthz_probe(SCHEDULER_PORT))
        self.registry.add_component_probe(
            "controller-manager", _healthz_probe(CONTROLLER_MANAGER_PORT))

        self.tunneler = None
        if cfg.enable_tunneler:
            from .api.relay import kubelet_base_for
            from .api.tunneler import WsTunneler

            def node_addresses():
                import urllib.parse as _up
                out = []
                nodes, _rev = self.registry.list("nodes", "")
                for node in nodes:
                    try:
                        base = kubelet_base_for(self.registry,
                                                node.metadata.name)
                    except Exception:
                        continue
                    split = _up.urlsplit(base)
                    if split.hostname and split.port:
                        out.append((node.metadata.name, split.hostname,
                                    split.port))
                return out

            self.tunneler = WsTunneler()
            self.tunneler.run(node_addresses)
            # node-proxy GETs ride the tunnels (master.go wires
            # tunneler.Dial into the proxy transport the same way)
            self.server.tunnel_dial = self.tunneler.dial
            # the tunnel-sync healthz gate (ref: master.go
            # IsTunnelSyncHealthy wired into apiserver healthz)
            self.registry.add_component_probe(
                "tunneler",
                lambda: ((True, "ok") if self.tunneler.healthy()
                         else (False,
                               f"tunnels last synced "
                               f"{self.tunneler.seconds_since_sync()}s "
                               f"ago (limit 600)")))

    @property
    def url(self) -> str:
        return self.server.url

    @property
    def port(self) -> int:
        return self.server.port

    # ------------------------------------------------ bootstrap loops
    # (ref: pkg/master/controller.go — the core controller that creates
    # the "default" namespace and the "kubernetes" master service, and
    # reconciles that service's endpoints to the live apiservers)

    def _bootstrap_once(self) -> None:
        import ipaddress
        from dataclasses import replace as _replace

        from .core import types as api
        from .core.errors import AlreadyExists, NotFound

        # 1. the namespace holding the master services (:133
        # CreateNamespaceIfNeeded)
        try:
            self.registry.create("namespaces", api.Namespace(
                metadata=api.ObjectMeta(name="default")))
        except AlreadyExists:
            pass
        # 2. the kubernetes service on the first IP of the service range
        # (:187 CreateOrUpdateMasterServiceIfNeeded; the reference pins
        # the range's base address)
        net = ipaddress.ip_network(self.config.service_cidr)
        master_ip = str(net.network_address + 1)
        port_name = "https" if self.config.tls_cert_file else "http"
        try:
            self.registry.get("services", "kubernetes", "default")
        except NotFound:
            try:
                self.registry.create("services", api.Service(
                    metadata=api.ObjectMeta(name="kubernetes",
                                            namespace="default",
                                            labels={"component":
                                                    "apiserver",
                                                    "provider":
                                                    "kubernetes"}),
                    spec=api.ServiceSpec(
                        cluster_ip=master_ip,
                        session_affinity="ClientIP",
                        ports=[api.ServicePort(name=port_name,
                                               port=self.server.port)])),
                    "default")
            except AlreadyExists:
                pass
        # 3. endpoints always carry this apiserver (:226
        # ReconcileEndpoints, master_count=1 form: exactly our address)
        want = api.Endpoints(
            metadata=api.ObjectMeta(name="kubernetes",
                                    namespace="default"),
            subsets=[api.EndpointSubset(
                addresses=[api.EndpointAddress(ip=self.config.host)],
                ports=[api.EndpointPort(name=port_name,
                                        port=self.server.port)])])
        try:
            current = self.registry.get("endpoints", "kubernetes",
                                        "default")
            if current.subsets != want.subsets:
                self.registry.update(
                    "endpoints", _replace(current,
                                          subsets=want.subsets),
                    "default")
        except NotFound:
            try:
                self.registry.create("endpoints", want, "default")
            except AlreadyExists:
                pass

    def _bootstrap_loop(self) -> None:
        while not self._bootstrap_stop.wait(10.0):
            try:
                self._bootstrap_once()
            except Exception:
                pass  # next tick retries (crash-only)

    def start(self) -> "Master":
        import threading
        self.server.start()
        self._bootstrap_stop = threading.Event()
        try:
            self._bootstrap_once()
        except Exception:
            pass  # the loop retries
        self._bootstrap_thread = threading.Thread(
            target=self._bootstrap_loop, daemon=True,
            name="master-bootstrap")
        self._bootstrap_thread.start()
        return self

    def stop(self) -> None:
        if getattr(self, "_bootstrap_stop", None) is not None:
            self._bootstrap_stop.set()
        self.server.stop()
        if self.tunneler is not None:
            self.tunneler.stop()
        if self.store is not None and hasattr(self.store, "close"):
            self.store.close()
