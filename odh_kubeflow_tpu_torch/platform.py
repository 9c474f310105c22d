"""All-in-one platform server (and the split-process building blocks):
the port's copy of the JAX package's ``platform.py``, on GPU node pools.

``python -m odh_kubeflow_tpu_torch.platform`` boots the whole control
plane in one process — the standalone analog of the reference's full
deployment:

- embedded APIServer with the kubeflow CRDs + admission webhooks
  registered in-process, served over REST (``machinery.httpapi``) so
  out-of-process components (``python -m odh_kubeflow_tpu_torch.
  controllers.notebook`` et al.) can attach via
  ``machinery.client.RemoteAPIServer``; ``WAL_DIR`` makes it durable and
  ``STORE_PARTITIONS=N`` shards it by namespace into N partitions behind
  a ``PartitionRouter`` (``machinery/partition.py``);
- controller manager running the notebook / profile / tensorboard
  reconcilers + culler, the session manager, the gang scheduler and the
  warm pools, all reading through one informer cache;
- the web layer (central dashboard, JWA, VWA, TWA, kfam) on one port
  behind a prefix router — the same path layout the Istio
  VirtualServices give the reference (`/jupyter/...`, `/volumes/...`);
- optionally (``--sim``) the fake kubelet/scheduler so spawned
  notebooks actually "run" without a cluster — the local-dev story,
  with ``--sim-gpu-nodes`` nodes of an ``nvidia-h100-80gb`` pool of 8
  GPUs each (JAX's ``--sim-tpu-nodes`` v5e nodes). A durable ``--sim``
  platform restarts on its own ``WAL_DIR``: its nodes re-register as a
  kubelet's do (JAX's raises ``AlreadyExists`` there).

Config: flags + the reference's env contract
(USE_ISTIO/ENABLE_CULLING/CULL_IDLE_TIME/...). Nothing here imports
torch: the notebooks' processes are the card's side.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from typing import Any, Optional

from odh_kubeflow_tpu_torch.apis import install_default_cluster_roles, register_crds
from odh_kubeflow_tpu_torch.controllers.culler import Culler, CullerConfig
from odh_kubeflow_tpu_torch.controllers.notebook import (
    NotebookController,
    NotebookControllerConfig,
)
from odh_kubeflow_tpu_torch.controllers.profile import ProfileController
from odh_kubeflow_tpu_torch.controllers.runtime import Manager
from odh_kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
from odh_kubeflow_tpu_torch.machinery import httpapi
from odh_kubeflow_tpu_torch.machinery.cache import (
    CachedClient,
    InformerCache,
    register_platform_indexers,
)
from odh_kubeflow_tpu_torch.machinery.kubelet import FakeCluster
from odh_kubeflow_tpu_torch.machinery.partition import (
    build_partitions,
    partitions_from_env,
)
from odh_kubeflow_tpu_torch.machinery.store import APIServer
from odh_kubeflow_tpu_torch.machinery.usage import (
    UsageConfig,
    UsageMeter,
    register_usage,
)
from odh_kubeflow_tpu_torch.scheduling import register_scheduling
from odh_kubeflow_tpu_torch.scheduling.scheduler import SliceScheduler
from odh_kubeflow_tpu_torch.sessions import register_sessions
from odh_kubeflow_tpu_torch.sessions.manager import SessionConfig, SessionManager
from odh_kubeflow_tpu_torch.utils import prometheus
from odh_kubeflow_tpu_torch.utils.slo import SLOEngine
from odh_kubeflow_tpu_torch.warmup import register_warmup
from odh_kubeflow_tpu_torch.warmup.compilecache import (
    CompileCacheConfig,
    CompileCacheService,
)
from odh_kubeflow_tpu_torch.warmup.pool import WarmPoolConfig, WarmPoolController
from odh_kubeflow_tpu_torch.web.dashboard import DashboardApp
from odh_kubeflow_tpu_torch.web.jwa import JupyterWebApp
from odh_kubeflow_tpu_torch.web.kfam_app import KfamApp
from odh_kubeflow_tpu_torch.web.twa import TensorboardsWebApp
from odh_kubeflow_tpu_torch.web.vwa import VolumesWebApp
from odh_kubeflow_tpu_torch.webhooks.notebook import NotebookWebhook
from odh_kubeflow_tpu_torch.webhooks.poddefault import PodDefaultWebhook

Obj = dict[str, Any]

# the --sim cluster's GPU node pool (JAX's: v5e 2x2 TPU nodes)
SIM_GPU_POOL = "h100-pool"
SIM_GPU_ACCELERATOR = "nvidia-h100-80gb"
SIM_GPUS_PER_NODE = 8


class PrefixRouter:
    """WSGI dispatcher: longest-prefix match; ``strip=True`` mounts an
    app that thinks it lives at ``/`` (JWA/VWA/TWA), ``strip=False``
    mounts one whose routes already carry the prefix (kfam)."""

    def __init__(self, fallback):
        self.fallback = fallback
        self._mounts: list[tuple[str, Any, bool]] = []

    def mount(self, prefix: str, app, strip: bool = True) -> "PrefixRouter":
        self._mounts.append((prefix.rstrip("/"), app, strip))
        self._mounts.sort(key=lambda m: -len(m[0]))
        return self

    def __call__(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        for prefix, app, strip in self._mounts:
            if path == prefix or path.startswith(prefix + "/"):
                if strip:
                    environ = dict(environ)
                    environ["SCRIPT_NAME"] = (
                        environ.get("SCRIPT_NAME", "") + prefix
                    )
                    environ["PATH_INFO"] = path[len(prefix):] or "/"
                return app(environ, start_response)
        return self.fallback(environ, start_response)


class Platform:
    """Owns every in-process component; ``start()``/``stop()`` for
    serving, or use the components directly in tests."""

    def __init__(
        self,
        *,
        nb_config: Optional[NotebookControllerConfig] = None,
        sim: bool = False,
        spawner_config_path: Optional[str] = None,
    ):
        # WAL_DIR=<path> makes the embedded apiserver durable: every
        # mutation is WAL-logged + fsync'd before it is acked, a
        # snapshot is cut every SNAPSHOT_INTERVAL mutations, and boot
        # recovers the previous incarnation's objects, rv history, and
        # watch-resume window from disk. Unset = the in-memory-only store.
        wal_dir = os.environ.get("WAL_DIR", "")
        # STORE_PARTITIONS=N shards the write path by namespace into N
        # independent WAL+group-commit stacks behind a PartitionRouter
        # (machinery/partition.py); 1 = the classic
        # single-leader store, no router in the path.
        n_partitions = partitions_from_env()
        snap_every = int(os.environ.get("SNAPSHOT_INTERVAL", "1024"))
        # byte-based cadence rides alongside the count-based one
        # (SNAPSHOT_BYTES=0 disables); GROUP_COMMIT=false pins the
        # committer to one fsync per record (debug/bench baseline)
        snap_bytes = int(os.environ.get("SNAPSHOT_BYTES", "0"))
        group = os.environ.get("GROUP_COMMIT", "true").lower() == "true"
        durable_kwargs = dict(
            snapshot_interval=snap_every,
            snapshot_bytes=snap_bytes,
            group_commit=group,
        )
        if n_partitions > 1:
            # each partition recovers its own WAL under <WAL_DIR>/p<i>
            # (in-memory partitions when WAL_DIR is unset)
            self.api = build_partitions(
                n_partitions,
                wal_dir=wal_dir,
                **(durable_kwargs if wal_dir else {}),
            )
        elif wal_dir:
            from odh_kubeflow_tpu_torch.machinery.wal import WriteAheadLog

            self.api = APIServer.recover(
                WriteAheadLog(wal_dir), **durable_kwargs
            )
        else:
            self.api = APIServer()
        register_crds(self.api)
        register_scheduling(self.api)
        register_sessions(self.api)
        register_usage(self.api)
        register_warmup(self.api)
        install_default_cluster_roles(self.api)
        PodDefaultWebhook(self.api).register()
        NotebookWebhook(self.api).register()

        # one platform-wide registry: controller-runtime metrics, the
        # notebook controller's counters, and anything components add
        # all scrape from the apiserver's /metrics
        self.metrics_registry = prometheus.Registry()
        # WAL/commit-pipeline instruments (fsyncs per batch, batch
        # size, ack latency) — no-op for the in-memory store
        self.api.attach_metrics(self.metrics_registry)
        # declarative SLOs evaluated as multi-window burn rates from
        # the live histograms (utils/slo.py): slo_burn_rate gauges on
        # /metrics, rows on the dashboard's /api/slo
        self.slo_engine = SLOEngine(self.metrics_registry)

        # the shared informer cache + indexed zero-copy client: every
        # controller and web backend reads through it; writes and
        # watches pass straight to the store. The webhooks and the
        # kubelet sim stay on the raw store (they run INSIDE the write
        # path and must see uncached truth).
        self.cache = InformerCache(self.api, registry=self.metrics_registry)
        register_platform_indexers(self.cache)
        self.cached_api = CachedClient(self.api, self.cache)

        self.nb_config = nb_config or NotebookControllerConfig.from_env()
        culler_cfg = CullerConfig(
            cull_idle_seconds=self.nb_config.cull_idle_seconds,
            idleness_check_seconds=self.nb_config.idleness_check_seconds,
            cluster_domain=self.nb_config.cluster_domain,
            # with sessions on, culls suspend-to-checkpoint instead of
            # stopping cold — the idle slice frees, the kernel survives
            suspend_on_cull=self.nb_config.enable_sessions,
        )
        self.manager = Manager(
            self.api, registry=self.metrics_registry, cache=self.cache
        )
        # the sim cluster is built before the controllers so its
        # checkpoint/restore container hooks can back the SessionManager
        self.cluster = FakeCluster(self.api) if sim else None
        # GPU-second metering (machinery/usage.py): ALWAYS constructed —
        # its counter families anchor the idle-waste SLO and the
        # dashboard showback even when the USAGE_METERING flag only
        # gates the background sampling thread. In sim mode the sampler
        # reads the cluster's deterministic duty-cycle waveforms; in a
        # real deployment it probes the in-pod activity agent.
        self.usage_config = UsageConfig.from_env()
        self.usage_meter = UsageMeter(
            self.cached_api,
            self.usage_config,
            registry=self.metrics_registry,
            sample_fn=(
                (lambda ns, nb: self.cluster.duty_cycle(ns, nb))
                if sim
                else None
            ),
        )
        self.usage_meter.recover()
        self.culler = Culler(
            self.cached_api, culler_cfg, meter=self.usage_meter
        )
        self.notebook_controller = NotebookController(
            self.cached_api,
            self.nb_config,
            registry=self.metrics_registry,
            culler=self.culler if self.nb_config.enable_culling else None,
            meter=self.usage_meter,
        )
        self.notebook_controller.register(self.manager)
        # suspend-to-checkpoint sessions (sessions/): snapshots kernels
        # on cull/preempt, restores on resume, and gives the scheduler
        # its checkpoint-then-preempt hooks
        self.session_manager = None
        if self.nb_config.enable_sessions:
            self.session_manager = SessionManager(
                self.cached_api,
                SessionConfig.from_env(),
                registry=self.metrics_registry,
                runtime=(
                    self.cluster.session_runtime
                    if self.cluster is not None
                    else None
                ),
                meter=self.usage_meter,
            )
            self.session_manager.register(self.manager)
        # gang admission for GPU gangs (scheduling/): the notebook
        # controller only creates Workloads when queueing is on, and
        # without a scheduler they would pend forever
        self.scheduler = (
            SliceScheduler(
                self.cached_api,
                registry=self.metrics_registry,
                suspender=self.session_manager,
                meter=self.usage_meter,
            )
            if self.nb_config.enable_queueing
            else None
        )
        if self.scheduler is not None:
            self.scheduler.register(self.manager)
        # warm-start subsystem (warmup/): the compilation-cache service
        # is always constructed (its metrics anchor the warm-compile
        # gate, and trainer/engine precompile routes through it); the
        # warm-pool controller only runs when queueing is on — standbys
        # are admitted through the slice queue, and without a scheduler
        # they would pend forever (same gate as the scheduler itself).
        self.compile_cache = CompileCacheService(
            self.cached_api,
            CompileCacheConfig.from_env(),
            registry=self.metrics_registry,
        )
        self.warm_pool_config = WarmPoolConfig.from_env()
        self.warm_pool_controller = None
        if self.nb_config.enable_queueing and self.warm_pool_config.enabled:
            self.warm_pool_controller = WarmPoolController(
                self.cached_api,
                self.warm_pool_config,
                registry=self.metrics_registry,
                session_store=(
                    self.session_manager.store
                    if self.session_manager is not None
                    else None
                ),
                compile_cache=self.compile_cache,
            )
            self.warm_pool_controller.register(self.manager)
        self.profile_controller = ProfileController(self.cached_api)
        self.profile_controller.register(self.manager)
        self.tensorboard_controller = TensorboardController(self.cached_api)
        self.tensorboard_controller.register(self.manager)

        self.jwa = JupyterWebApp(
            self.cached_api,
            config_path=spawner_config_path,
            registry=self.metrics_registry,
            meter=self.usage_meter,
        )
        self.vwa = VolumesWebApp(self.cached_api, registry=self.metrics_registry)
        self.twa = TensorboardsWebApp(
            self.cached_api, registry=self.metrics_registry
        )
        self.kfam = KfamApp(self.cached_api, registry=self.metrics_registry)
        self.dashboard = DashboardApp(
            self.cached_api,
            kfam=self.kfam.service,
            registry=self.metrics_registry,
            slo_engine=self.slo_engine,
            meter=self.usage_meter,
        )

        self.web = PrefixRouter(self.dashboard.app)
        self.web.mount("/jupyter", self.jwa.app)
        self.web.mount("/volumes", self.vwa.app)
        self.web.mount("/tensorboards", self.twa.app)
        self.web.mount("/kfam", self.kfam.app, strip=False)

        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._api_httpd = None
        self._web_httpd = None

    # -- lifecycle ----------------------------------------------------------

    def start(
        self, api_port: int = 8001, web_port: int = 8080, host: str = "127.0.0.1"
    ) -> tuple[int, int]:
        """Starts controllers + servers on daemon threads; returns the
        bound (api_port, web_port)."""
        self.manager.start()
        self.slo_engine.start(
            interval=float(os.environ.get("SLO_TICK_SECONDS", "5"))
        )
        # duty-cycle sampling + ledger flush loop (no-op when
        # USAGE_METERING=false — the meter still exists for its hooks)
        self.usage_meter.start()
        _, api_port, self._api_httpd = httpapi.serve(
            self.api,
            host,
            api_port,
            metrics_registry=self.metrics_registry,
            usage_meter=self.usage_meter,
        )

        web_thread, web_port, self._web_httpd = _serve_wsgi(
            self.web, host, web_port
        )
        self._threads.append(web_thread)

        if self.cluster is not None:
            t = threading.Thread(target=self._sim_loop, daemon=True)
            t.start()
            self._threads.append(t)
        return api_port, web_port

    def _sim_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.cluster.step()
            except Exception:  # noqa: BLE001 — sim must keep ticking
                pass
            self._stop.wait(0.5)

    def stop(self) -> None:
        self._stop.set()
        self.usage_meter.stop()
        self.slo_engine.stop()
        self.manager.stop()
        for httpd in (self._api_httpd, self._web_httpd):
            if httpd is not None:
                httpd.shutdown()


def _serve_wsgi(app, host: str, port: int) -> tuple[threading.Thread, int, Any]:
    from odh_kubeflow_tpu_torch.machinery import eventloop

    if eventloop.event_loop_enabled():
        srv = eventloop.serve_wsgi(app, host, port)
        return srv._thread, srv.server_address[1], srv

    from wsgiref.simple_server import make_server

    httpd = make_server(
        host,
        port,
        app,
        server_class=httpapi._ThreadingServer,
        handler_class=httpapi._QuietHandler,
    )
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t, httpd.server_address[1], httpd


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="odh-kubeflow-tpu-torch platform")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--api-port", type=int, default=8001)
    parser.add_argument("--web-port", type=int, default=8080)
    parser.add_argument(
        "--sim",
        action="store_true",
        help="run the fake kubelet/scheduler (local dev: notebooks 'run')",
    )
    parser.add_argument(
        "--sim-gpu-nodes",
        type=int,
        default=int(os.environ.get("SIM_GPU_NODES", "1")),
        help="with --sim: H100 nodes (8 GPUs each) to register",
    )
    parser.add_argument("--spawner-config", default=os.environ.get("UI_CONFIG"))
    args = parser.parse_args(argv)

    platform = Platform(sim=args.sim, spawner_config_path=args.spawner_config)
    if platform.cluster is not None:
        platform.cluster.add_node("cpu-0", cpu="32", memory="128Gi")
        if args.sim_gpu_nodes:
            platform.cluster.add_gpu_node_pool(
                SIM_GPU_POOL,
                accelerator_type=SIM_GPU_ACCELERATOR,
                num_nodes=args.sim_gpu_nodes,
                gpus_per_node=SIM_GPUS_PER_NODE,
            )
    api_port, web_port = platform.start(args.api_port, args.web_port, args.host)
    print(
        f"platform up: api http://{args.host}:{api_port} "
        f"web http://{args.host}:{web_port}"
        + (" (sim cluster)" if platform.cluster else ""),
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        platform.stop()


if __name__ == "__main__":
    main()
