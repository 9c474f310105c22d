"""Shared process entrypoint plumbing for split-process components
(the port's copy of the JAX package's ``machinery/runner.py``).

Every ``python -m odh_kubeflow_tpu_torch.<component>`` command line boots
the same way: attach to $KUBE_API_URL, build the component,
serve/reconcile forever. One implementation here so the contract (env
names, banner, lifecycle) cannot drift across the entrypoints. The
processes it starts are host-only: nothing here imports torch.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional


def _partition_leaders(api):
    """``PARTITION_LEADERS=<url0>,<url1>,…``: client-side routing for
    a partitioned write path (machinery.partition) — one remote client
    per partition leader behind a PartitionRouter, so every mutation
    goes STRAIGHT to its namespace's owning leader instead of paying a
    307 redirect hop, and cluster-spanning lists/watches merge
    client-side with composite continue tokens. Unset = the single
    ``KUBE_API_URL`` endpoint, exactly the old wiring."""
    raw = os.environ.get("PARTITION_LEADERS", "")
    if not raw:
        return api
    from odh_kubeflow_tpu_torch.machinery.client import api_from_env
    from odh_kubeflow_tpu_torch.machinery.partition import PartitionRouter

    urls = [u.strip().rstrip("/") for u in raw.split(",") if u.strip()]
    backends = {i: api_from_env(url=u) for i, u in enumerate(urls)}
    # owned = every partition: the client routes writes itself; each
    # backend is that partition's own leader, no redirect needed
    return PartitionRouter(backends, urls=dict(enumerate(urls)))


def _split_reads(api):
    """``READ_FROM_REPLICA=<url>[,<url>…]``: serve this component's
    reads — lists, watches (so the informer cache feeds off the
    replica), and gets — from follower replicas, writes from the
    leader as before. A comma-separated list spreads reads across N
    replicas (round-robin, rendezvous-sticky watches) with
    per-endpoint failure fallback to the next replica. The replica's
    bounded-staleness contract (X-Served-RV horizon, wait-or-410 on
    pinned rvs) rides along; unset = everything to the leader,
    exactly the old wiring."""
    read_url = os.environ.get("READ_FROM_REPLICA", "")
    if not read_url:
        return api
    from odh_kubeflow_tpu_torch.machinery.client import api_from_env
    from odh_kubeflow_tpu_torch.machinery.replica import ReadSplitAPI

    return ReadSplitAPI(api, api_from_env(url=read_url))


def _wrap_cached(api, registry=None):
    """Front the remote api with the informer-backed shared cache
    (reads become watch-fed, indexed, zero-copy; writes pass through).
    ``INFORMER_CACHE=false`` opts out — e.g. a debug run against an
    apiserver whose watch path is suspect. The cache's counters go to
    ``registry`` (the one ``run_controller`` serves at ``/metrics``; the
    JAX runner leaves them on the process default, which no controller
    serves)."""
    if os.environ.get("INFORMER_CACHE", "true").lower() != "true":
        return api, None
    from odh_kubeflow_tpu_torch.machinery.cache import (
        CachedClient,
        InformerCache,
        register_platform_indexers,
    )

    # only cache kinds the remote registry knows (CRDs were registered
    # by api_from_env; a kind the server rejects would fail the watch)
    from odh_kubeflow_tpu_torch.machinery.cache import DEFAULT_CACHED_KINDS

    from odh_kubeflow_tpu_torch.machinery.store import NotFound

    kinds = []
    for kind in DEFAULT_CACHED_KINDS:
        try:
            api.type_info(kind)
            kinds.append(kind)
        except NotFound:  # kind not registered with this server → skip
            continue
    cache = InformerCache(api, kinds=kinds, registry=registry)
    register_platform_indexers(cache)
    return CachedClient(api, cache), cache


def _install_span_exporter(api) -> None:
    """Ship finished spans to the apiserver's ``/debug/traces/ingest``
    so split-process hops (webhook→store→reconcile→scheduler→kubelet)
    assemble into ONE trace on its /debug/traces zpage. TRACE_EXPORT=
    false opts out; no endpoint (embedded api) is a no-op."""
    if os.environ.get("TRACE_EXPORT", "true").lower() != "true":
        return
    base_url = getattr(api, "base_url", None)
    if not base_url:
        return
    from odh_kubeflow_tpu_torch.utils import tracing

    tracing.RemoteSpanExporter(base_url).install()


def _lease_periods(lease_duration: float) -> dict:
    """The elector's renew and retry periods, from the lease alone: the
    JAX runner's 5 s and 2 s (its ``LeaderElector`` defaults), capped at
    a third and a quarter of the lease. At the default 15 s lease the two
    agree; a short ``LEASE_DURATION`` still renews inside its own window,
    and a holder whose renewal fails while writes have no leader (an
    apiserver failover) tries again well before its lease lapses."""
    return {"renew_period": min(5.0, lease_duration / 3.0),
            "retry_period": min(2.0, lease_duration / 4.0)}


def run_controller(name: str, register: Callable) -> None:
    """``register(api, mgr)`` wires controllers into the manager.

    LEADER_ELECT=true (flag parity: notebook-controller/main.go:56-70)
    gates reconciling on holding a coordination.k8s.io Lease named
    ``<name>-leader`` — replicas > 1 become an HA pair. Losing the
    lease exits the process (controller-runtime semantics: never keep
    reconciling without it)."""
    from odh_kubeflow_tpu_torch.controllers.runtime import Manager
    from odh_kubeflow_tpu_torch.machinery.client import api_from_env
    from odh_kubeflow_tpu_torch.machinery.faults import maybe_wrap

    # GRAFT_CHAOS=<seed>: deterministic fault injection on the API path
    # (chaos soak runs); unset = the raw client, zero overhead
    from odh_kubeflow_tpu_torch.utils import prometheus

    raw = api_from_env()
    _install_span_exporter(raw)
    api = maybe_wrap(_partition_leaders(raw))
    registry = prometheus.Registry()
    api, cache = _wrap_cached(_split_reads(api), registry)

    elector = None
    shard = None
    if os.environ.get("LEADER_ELECT", "").lower() == "true":
        from odh_kubeflow_tpu_torch.machinery.leader import LeaderElector

        lease_duration = float(os.environ.get("LEASE_DURATION", "15"))
        elector = LeaderElector(
            api,
            os.environ.get("LEADER_ELECTION_ID", f"{name}-leader"),
            namespace=os.environ.get("LEADER_ELECTION_NAMESPACE", "kubeflow"),
            lease_duration=lease_duration,
            **_lease_periods(lease_duration),
        )
        print(f"{name}: waiting for leader lease…", flush=True)
        elector.acquire()

        def lost():
            print(f"{name}: leader lease lost; exiting", flush=True)
            os._exit(1)

        elector.run(on_lost=lost)

    # SHARD_GROUP=<group>: horizontally-replicated manager — this
    # replica joins the shard group and reconciles only the namespaces
    # it owns under rendezvous hashing; its writes carry the membership
    # lease's fencing token. Losing the membership heartbeat exits the
    # process (peers already resharded our slice).
    if os.environ.get("SHARD_GROUP", ""):
        from odh_kubeflow_tpu_torch.machinery.leader import ShardMembership

        shard = ShardMembership(
            api,
            os.environ["SHARD_GROUP"],
            identity=os.environ.get("SHARD_IDENTITY") or None,
            namespace=os.environ.get("LEADER_ELECTION_NAMESPACE", "kubeflow"),
            lease_duration=float(os.environ.get("LEASE_DURATION", "15")),
        )
        shard.join()

        def shard_lost():
            print(f"{name}: shard membership lost; exiting", flush=True)
            os._exit(1)

        shard.run(on_lost=shard_lost)
        print(
            f"{name}: shard member {shard.identity} of "
            f"{shard.group} (epoch {shard.token})",
            flush=True,
        )

    mgr = Manager(api, registry=registry, cache=cache, elector=elector, shard=shard)
    register(api, mgr)
    mgr.start()  # includes the informer start/sync barrier

    # controller-runtime's --metrics-bind-address: every split-process
    # controller serves its manager registry on its own port.
    # METRICS_PORT=0 disables (e.g. sidecar-less debug runs).
    metrics_port = int(os.environ.get("METRICS_PORT", "8080"))
    if metrics_port:
        _, bound, _ = prometheus.serve_metrics(
            mgr.metrics_registry,
            os.environ.get("METRICS_HOST", "0.0.0.0"),
            metrics_port,
        )
        print(f"{name} metrics on :{bound}/metrics", flush=True)
    print(f"{name} running", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        mgr.stop()
        if elector is not None:
            elector.release()
        if shard is not None:
            shard.leave()


def run_replica(name: str = "replica") -> None:
    """``REPLICA_OF=<leader-url>``: run a follower read replica — WAL
    stream pulled from the leader, list/watch served locally, writes
    307'd back at the leader. Deployment shape: one leader + N of
    these behind a read load balancer, with controllers/web apps
    pointed at them via ``READ_FROM_REPLICA``."""
    from odh_kubeflow_tpu_torch.machinery.replica import serve_replica

    serve_replica()


def run_web(name: str, default_port: int, build: Callable,
            register: Optional[Callable] = None) -> None:
    """``build(api)`` returns an object exposing a ``.app`` WSGI app.
    ``register(api)`` registers on the client the kinds the app reads
    beyond the CRDs, before the informer cache picks the kinds it
    mirrors (the JAX runner has no such hook: its split JWA reads
    Workloads through a client that cannot name them)."""
    from odh_kubeflow_tpu_torch.machinery.client import api_from_env
    from odh_kubeflow_tpu_torch.machinery.faults import maybe_wrap

    raw = api_from_env()
    _install_span_exporter(raw)
    write = maybe_wrap(_partition_leaders(raw))
    split = _split_reads(write)
    if register is not None:
        register(write)
        if split is not write:
            register(split.read_api)
    api, cache = _wrap_cached(split)
    if cache is not None:
        cache.start(live=True)
        cache.wait_for_sync()
    backend = build(api)
    host = os.environ.get("HOST", "0.0.0.0")
    port = int(os.environ.get("PORT", str(default_port)))
    httpd = backend.app.serve(host, port)
    print(f"{name} on http://{host}:{httpd.server_address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()
