"""hyperkube — the all-in-one component multiplexer of the port.

Reference: cmd/hyperkube/main.go:42 (one binary, component picked by the
first argument). The split deployment runs as separate processes:

    python -m kubernetes_tpu_torch apiserver --port 8080 --storage-backend native
    python -m kubernetes_tpu_torch hollow-fleet --master http://127.0.0.1:8080 --num-nodes 100
    python -m kubernetes_tpu_torch scheduler --master http://127.0.0.1:8080 --mode batch
    python -m kubernetes_tpu_torch controller-manager --master http://127.0.0.1:8080
    python -m kubernetes_tpu_torch migrate-storage --master http://127.0.0.1:8080

The scheduler is the one component that touches a device: its batch
engine runs on the CUDA device, or on the CPU with `--cpu`. Without
`--cpu` and without a card it exits non-zero with the engine's error and
never runs on the CPU quietly. The other components of the JAX package's
hyperkube (kubelet, hollow-node, proxy, dns, kubectl) are not ported
(ROADMAP.md Queue 1).

Each long-running component prints one READY line to stdout
(`<component> ready <detail>`) once serving — process supervisors and the
multi-process tests key on it — then blocks until SIGTERM/SIGINT, stops
cleanly, and exits 0. The batch scheduler prints one more line as it
exits, `scheduler launches {...}`: each kernel's launches in the process
(a JSON object keyed by kernel), so a supervisor can tell that the
scheduling ran through the kernels.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, List, Optional


def _read_lines(path: Optional[str]) -> Optional[List[str]]:
    if not path:
        return None
    with open(path) as f:
        return f.read().splitlines()


def _wait_for_master(url: str, timeout_s: float = 60.0) -> None:
    """Block until the apiserver's /healthz answers (components race the
    master at process start; the reference's client retries likewise)."""
    deadline = time.time() + timeout_s
    last: Exception = RuntimeError("never tried")
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                        timeout=5) as resp:
                if resp.status == 200:
                    return
        except (urllib.error.URLError, OSError) as e:
            last = e
        time.sleep(0.1)
    raise RuntimeError(f"master {url} not healthy after {timeout_s}s: {last}")


def _start_healthz(component: str, port: Optional[int] = None):
    """Serve healthz/metrics on the component's conventional port
    (scheduler :10251 / controller-manager :10252, the ports the
    apiserver's componentstatus resource probes; ref: plugin/cmd/
    kube-scheduler/app/server.go:128-143), or on `port`. Best effort: a
    taken port (tests, several schedulers) disables the server rather
    than the component."""
    from .utils.healthz import (CONTROLLER_MANAGER_PORT, SCHEDULER_PORT,
                                HealthzServer)
    if port is None:
        port = (SCHEDULER_PORT if component == "scheduler"
                else CONTROLLER_MANAGER_PORT)
    try:
        server = HealthzServer(port=port).start()
        return server.stop
    except OSError:
        return lambda: None


def _make_recorder(client, component: str, host: str = ""):
    """One event recorder posting to the apiserver (the per-binary
    EventBroadcaster wiring every reference component repeats)."""
    from .api.record import ClientEventSink, EventBroadcaster
    from .core import types as api
    return EventBroadcaster().start_recording_to_sink(
        ClientEventSink(client)).new_recorder(
        api.EventSource(component=component, host=host))


def _serve_until_signal(ready_line: str, stop_fns,
                        exit_line: Optional[Callable[[], str]] = None
                        ) -> int:
    """Print the READY line, then park until SIGTERM/SIGINT and unwind;
    then print exit_line() if given."""
    stop_event = threading.Event()

    def on_signal(signum, frame):
        stop_event.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    print(ready_line, flush=True)
    stop_event.wait()
    for fn in stop_fns:
        try:
            fn()
        except Exception:
            pass
    if exit_line is not None:
        print(exit_line(), flush=True)
    return 0


def _kernel_launches() -> str:
    """`scheduler launches {...}`: each kernel wrapper's launch count in
    this process (a wrapper counts only the launches of its kernel, so
    on the CPU every count is 0)."""
    from .sched.device import (filter_kernel, reject_kernel, scan_kernel,
                               scatter_kernel, spec_kernel, victim_kernel)
    counts = {
        "scan_chunk": scan_kernel.scan_chunk.launches,
        "scatter_prologue": scatter_kernel.launch_staged.launches,
        "probe": scan_kernel.probe.launches,
        "filter_masks": filter_kernel.filter_masks.launches,
        "argsort_rows": reject_kernel.argsort_rows.launches,
        "victim_search": victim_kernel.victim_search.launches,
        "victim_search_sharded":
            victim_kernel.victim_search_sharded.launches,
        "scan_chunk_sharded": scan_kernel.scan_chunk_sharded.launches,
        "spec_pass": spec_kernel.spec_pass.launches,
        "spec_repair": spec_kernel.spec_repair.launches}
    return "scheduler launches " + json.dumps(counts)


# ------------------------------------------------------------- components

def _parse_runtime_config(spec: str) -> "dict | None":
    """'k1=false,k2,k3=true' -> {k1: False, k2: True, ...}; a bare key
    means true, matching the reference's ConfigurationMap.Set
    (pkg/util/configuration_map.go)."""
    out = {}
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        key, _, val = pair.partition("=")
        val = val.strip().lower()
        if val in ("", "true", "1"):
            out[key.strip()] = True
        elif val in ("false", "0"):
            out[key.strip()] = False
        else:
            # fail at startup like the reference's boolean parse; a typo
            # ("=flase") must not silently invert into the permissive
            # setting
            raise SystemExit(
                f"--runtime-config: invalid boolean {val!r} for "
                f"{key.strip()!r}")
    return out or None


def run_apiserver(argv: List[str]) -> int:
    """(ref: cmd/kube-apiserver/app/server.go:358 APIServer.Run)"""
    p = argparse.ArgumentParser(prog="apiserver")
    p.add_argument("--bind-address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--storage-backend", choices=["memory", "native"],
                   default="memory")
    p.add_argument("--admission-control", default="",
                   help="ordered comma-separated plugin list "
                        "(ref: server.go:230)")
    p.add_argument("--basic-auth-file")
    p.add_argument("--token-auth-file")
    p.add_argument("--authorization-mode", default="AlwaysAllow",
                   choices=["AlwaysAllow", "AlwaysDeny", "ABAC"])
    p.add_argument("--authorization-policy-file")
    p.add_argument("--service-cluster-ip-range", default="10.0.0.0/24")
    p.add_argument("--max-requests-inflight", type=int, default=400)
    p.add_argument("--tls-cert-file", default="",
                   help="serve HTTPS (ref: --tls-cert-file)")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument("--client-ca-file", default="",
                   help="verify client certs against this CA and enable "
                        "x509 authentication (ref: --client-ca-file)")
    p.add_argument("--oidc-jwks-file", default="",
                   help="JWKS document for RS256 ID-token verification "
                        "(ref: --oidc-issuer-url + provider JWKS sync; "
                        "zero-egress stand-in for the discovery fetch)")
    p.add_argument("--oidc-issuer-url", default="")
    p.add_argument("--oidc-client-id", default="")
    p.add_argument("--oidc-username-claim", default="sub")
    p.add_argument("--oidc-groups-claim", default="groups")
    p.add_argument("--experimental-keystone-url", default="",
                   help="delegate basic-auth to a keystone v2 endpoint "
                        "(ref: --experimental-keystone-url)")
    p.add_argument("--runtime-config", default="",
                   help="comma-separated key=value pairs turning API "
                        "versions/resources on or off: api/v1, "
                        "apis/extensions/v1beta1, "
                        "apis/extensions/v1beta1/<resource>; api/all "
                        "and api/legacy are special keys "
                        "(ref: server.go:244)")
    args = p.parse_args(argv)

    from .master import Master, MasterConfig
    master = Master(MasterConfig(
        host=args.bind_address, port=args.port,
        storage_backend=args.storage_backend,
        admission_control=[s for s in args.admission_control.split(",") if s],
        basic_auth_lines=_read_lines(args.basic_auth_file),
        token_auth_lines=_read_lines(args.token_auth_file),
        authorization_mode=args.authorization_mode,
        authorization_policy_lines=_read_lines(args.authorization_policy_file),
        service_cidr=args.service_cluster_ip_range,
        max_in_flight=args.max_requests_inflight,
        runtime_config=_parse_runtime_config(args.runtime_config),
        tls_cert_file=args.tls_cert_file,
        tls_key_file=args.tls_private_key_file,
        tls_client_ca_file=args.client_ca_file,
        oidc_jwks=(json.load(open(args.oidc_jwks_file))
                   if args.oidc_jwks_file else None),
        oidc_issuer=args.oidc_issuer_url,
        oidc_client_id=args.oidc_client_id,
        oidc_username_claim=args.oidc_username_claim,
        oidc_groups_claim=args.oidc_groups_claim,
        keystone_url=args.experimental_keystone_url)).start()
    # freeze the booted master out of the young generations
    # (utils/gctune.py) — the fan-out/serve path churns small objects
    from .utils.gctune import tune_for_server
    tune_for_server()
    return _serve_until_signal(f"apiserver ready {master.url}",
                               [master.stop])


def run_scheduler(argv: List[str]) -> int:
    """(ref: plugin/cmd/kube-scheduler/app/server.go:49-187)"""
    p = argparse.ArgumentParser(prog="scheduler")
    p.add_argument("--master", required=True)
    p.add_argument("--mode", choices=["batch", "serial"], default="batch")
    p.add_argument("--policy-config-file")
    p.add_argument("--algorithm-provider", default="DefaultProvider")
    p.add_argument("--no-rate-limit", action="store_true",
                   help="disable the 50/s bind rate limit "
                        "(--bind-pods-qps equivalent)")
    p.add_argument("--cpu", action="store_true",
                   help="run the batch engine on the CPU (its plain "
                        "versions) instead of the CUDA device")
    args = p.parse_args(argv)

    # the engine's device first: without a card and without --cpu the
    # scheduler stops here, before it watches or binds anything
    device = None
    if args.mode == "batch":
        from .utils.platform import pick_device
        try:
            device = pick_device(args.cpu)
        except RuntimeError as e:
            print(f"scheduler: {e}", file=sys.stderr, flush=True)
            return 1

    # A dedicated scheduler process: its thread re-enters Python between
    # device dispatches, and CPython's default 5ms GIL slice makes each
    # re-entry wait behind watch/IO threads (measured ~10% of e2e wall
    # at kubemark scale). Process-wide by design — this process exists
    # to schedule.
    sys.setswitchinterval(0.001)
    # steady-state server GC posture (no cycles in the API types;
    # see utils/gctune.py for the measurement behind it)
    from .utils.gctune import tune_for_server
    tune_for_server()
    from .api.client import HttpClient
    from .sched.api import policy_from_json
    from .sched.batch import BatchScheduler
    from .sched.factory import ConfigFactory
    from .sched.scheduler import Scheduler

    _wait_for_master(args.master)
    client = HttpClient(args.master)
    # FailedScheduling and friends as first-class events (the reference
    # scheduler's recorder, scheduler.go Error func)
    factory = ConfigFactory(client, rate_limit=not args.no_rate_limit,
                            recorder=_make_recorder(
                                client, "scheduler")).start()

    policy = None
    if args.policy_config_file:
        with open(args.policy_config_file) as f:
            policy = policy_from_json(f.read())

    config = (factory.create_batch(policy, device=device)
              if args.mode == "batch" else None)
    if config is not None:
        sched = BatchScheduler(config).run()
    else:
        # the fast-path ladder: batch > mixed (device probe + HTTP
        # extenders) > serial — each rung a provable fallback
        mixed = (factory.create_mixed(policy, device=device)
                 if args.mode == "batch" else None)
        if mixed is not None:
            sched = Scheduler(mixed).run()
        else:
            sched = Scheduler(
                factory.create_from_config(policy) if policy
                else factory.create_from_provider(
                    args.algorithm_provider)).run()
    # READY only once the node cache holds its first LIST: a pod created
    # after READY is scheduled against every node registered before it
    factory.node_informer.cache.wait_for_sync(60.0)
    stops = [sched.stop, factory.stop, _start_healthz("scheduler")]
    return _serve_until_signal(
        f"scheduler ready mode={args.mode}"
        + (f" device={device}" if device is not None else ""), stops,
        _kernel_launches if args.mode == "batch" else None)


def run_controller_manager(argv: List[str]) -> int:
    """(ref: cmd/kube-controller-manager/app/controllermanager.go:284)"""
    p = argparse.ArgumentParser(prog="controller-manager")
    p.add_argument("--master", required=True)
    p.add_argument("--port", type=int, default=None,
                   help="healthz/metrics port (default 10252, "
                        "controllermanager.go's --port)")
    p.add_argument("--allocate-node-cidrs", action="store_true",
                   help="assign each node a pod CIDR from "
                        "--cluster-cidr (controllermanager.go:228)")
    p.add_argument("--cluster-cidr", default="10.244.0.0/16")
    args = p.parse_args(argv)

    from .api.client import HttpClient
    from .controllers.manager import ControllerManager

    _wait_for_master(args.master)
    client = HttpClient(args.master)
    # controllers record first-class events (SuccessfulCreate, eviction
    # notices, ...) like the reference's per-controller recorders
    manager = ControllerManager(
        client, recorder=_make_recorder(client, "controller-manager"),
        allocate_node_cidrs=args.allocate_node_cidrs,
        cluster_cidr=args.cluster_cidr).run()
    return _serve_until_signal(
        "controller-manager ready",
        [manager.stop, _start_healthz("controller-manager", args.port)])


def run_hollow_fleet(argv: List[str]) -> int:
    """A fleet of hollow nodes in one process (ref: pkg/kubemark/ +
    test/kubemark/start-kubemark.sh: NUM_NODES hollow-node replicas)."""
    p = argparse.ArgumentParser(prog="hollow-fleet")
    p.add_argument("--master", required=True)
    p.add_argument("--num-nodes", type=int, default=100)
    p.add_argument("--name-prefix", default="hollow-")
    p.add_argument("--cpu", default="4")
    p.add_argument("--memory", default="32Gi")
    p.add_argument("--max-pods", type=int, default=40)
    p.add_argument("--heartbeat-interval", type=float, default=10.0)
    args = p.parse_args(argv)

    from .api.client import HttpClient
    from .kubemark.fleet import HollowFleet

    _wait_for_master(args.master)
    fleet = HollowFleet(HttpClient(args.master), args.num_nodes,
                        name_prefix=args.name_prefix, cpu=args.cpu,
                        memory=args.memory, max_pods=args.max_pods,
                        heartbeat_interval=args.heartbeat_interval).run()
    return _serve_until_signal(
        f"hollow-fleet ready nodes={args.num_nodes}", [fleet.stop])


def run_migrate_storage(argv: List[str]) -> int:
    """Rewrite every stored object through the current codec against a
    live apiserver (ref: hack/test-update-storage-objects.sh — the
    kubectl get | kubectl replace loop; one wire version is served, so
    this normalizes legacy/unknown fields rather than converting between
    versions — core/migrate.py)."""
    p = argparse.ArgumentParser(prog="migrate-storage")
    p.add_argument("--master", required=True)
    p.add_argument("--resources", default="",
                   help="comma-separated subset (default: everything)")
    args = p.parse_args(argv)

    from .api.client import HttpClient
    from .core.migrate import migrate_via_api

    _wait_for_master(args.master)
    resources = [r for r in args.resources.split(",") if r] or None
    report = migrate_via_api(HttpClient(args.master), resources)
    print(json.dumps(report.as_dict()))
    return 1 if report.failed else 0


COMPONENTS = {
    "apiserver": run_apiserver,
    "kube-apiserver": run_apiserver,
    "scheduler": run_scheduler,
    "kube-scheduler": run_scheduler,
    "controller-manager": run_controller_manager,
    "kube-controller-manager": run_controller_manager,
    "hollow-fleet": run_hollow_fleet,
    "migrate-storage": run_migrate_storage,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = " | ".join(sorted(set(COMPONENTS)))
        print(f"usage: python -m kubernetes_tpu_torch <{names}> [flags]")
        return 0 if argv else 1
    name = argv[0]
    if name not in COMPONENTS:
        print(f"unknown component {name!r}", file=sys.stderr)
        return 1
    return COMPONENTS[name](argv[1:])
