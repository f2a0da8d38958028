"""Admission control: the ordered mutating/validating plugin chain every
write passes through before hitting storage.

Reference: pkg/admission (interfaces.go, chain.go, plugins.go) and the
plugin set under plugin/pkg/admission (admit, deny, limitranger,
namespace autoprovision/exists/lifecycle, resourcequota, serviceaccount,
securitycontext). Wired into the registry's write path (the reference
wires it into the apiserver handlers, resthandler.go:326 createHandler ->
admit.Admit; our registry IS the handler layer both HTTP and in-proc
clients share).
"""

from .interfaces import Attributes, Forbidden, Interface, Operation
from .chain import Chain
from .plugins import new_from_plugins, register_plugin


def registry_hook(chain: Chain):
    """Adapt a Chain to the Registry.admission callable. Usage:

        registry = Registry()
        registry.admission = registry_hook(
            new_from_plugins(registry, ["NamespaceLifecycle", ...]))
    """
    def hook(operation, resource, obj, namespace="", name=""):
        attrs = Attributes(object=obj, namespace=namespace, name=name,
                           resource=resource, operation=operation)
        chain.admit(attrs)
        return attrs.object
    return hook


__all__ = ["Attributes", "Forbidden", "Interface", "Operation", "Chain",
           "new_from_plugins", "register_plugin", "registry_hook"]
