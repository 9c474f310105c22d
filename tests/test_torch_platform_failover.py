"""``chip_smoke.platform_failover_phase`` on the CPU: the highly available
control plane's drill with a stub in place of the notebook's 8B serve on
the card.

The apiserver, the follower replica, two notebook controllers and the
scheduler run as real processes through their entry points; the phase's
own gates (controller takeover and fencing, the follower's promotion
under A's token + 1 with nothing lost, a notebook Running after the
promotion, no reference import, the time limit) must all hold.
"""

import time

import chip_smoke


class _Done:
    """A finished process, as the phase's clean-up sees it."""

    returncode = 0

    def poll(self):
        return 0


def stub_notebook(env, root):
    """The notebook process's protocol without the card: the launches of
    two first requests (2 forwards) and the 16-token one (17 forwards),
    then the first request again once the phase says go."""
    assert env["ODH_TORCH_KERNEL_CACHE"], env
    per = chip_smoke.LAUNCHES_PER_FORWARD
    state = {"started": time.time()}

    def go():
        state["go_at"] = time.time()

    def result(limit=600.0):
        assert "go_at" in state, "the phase asked for the record before its go"
        return {"imported_s": 0.0, "service_s": 0.0, "first_token_s": 0.0,
                "go_s": state["go_at"] - state["started"], "answered_s": 0.0,
                "go_at": state["go_at"], "first": [7], "after_promotion": [7],
                "tokens": list(range(chip_smoke.SPAWN_NEW_TOKENS)),
                "stage_launches": [2 * per, 19 * per, 21 * per], "launches": 21 * per,
                "built": [], "device": "cpu", "reference_modules": []}

    return {"process": {"proc": _Done()}, "go": go, "result": result}


def test_platform_failover_phase_on_cpu():
    # the suite's other workers share these cores: the watchdog's polls
    # get a second of scheduling slack, the phase two minutes (the card
    # runs with no slack and 60 s)
    record, launches = chip_smoke.platform_failover_phase(
        run_notebook=stub_notebook, limit_s=120.0, scheduling_s=1.0)
    assert launches == 21 * chip_smoke.LAUNCHES_PER_FORWARD
    ct, af = record["controller_takeover"], record["apiserver_failover"]
    assert ct["deposed_write"] == "FencedOut" and not ct["deposed_applied"]
    assert ct["token"][1] == ct["token"][0] + 1
    assert af["epoch"][1] == af["epoch"][0] + 1
    assert not any(af["lost"].values())
    assert set(af["acked_beyond_follower"]) <= {"Lease"}
    assert af["old_epoch_write"] == af["old_epoch_replay"] == "FencedOut"
    assert record["nb2_post_to_running_s"] > 0 and not record["exited"]
    assert not any(record["reference"].values())
    # every controller served its informer cache's counters on /metrics
    assert record["caches"]["holder"]["cache_hits"] > 0


def test_platform_failover_serves_partitioned_settings(tmp_path):
    """The partitioned shapes serve: a comma-separated ``REPLICA_OF`` (one
    leader a partition) and ``REPLICA_OF`` at a router with ``STORE_PARTITIONS``
    (``?partition=``-scoped pulls) each run a follower whose merged
    Notebook list equals the leaders'; the scheduler's ``main()`` runs
    over ``PARTITION_LEADERS``. None of the processes loads torch."""
    import json
    import os
    import subprocess
    import sys
    import urllib.request

    from odh_kubeflow_tpu_torch.apis import register_crds
    from odh_kubeflow_tpu_torch.machinery import httpapi
    from odh_kubeflow_tpu_torch.machinery.partition import build_partitions
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.scheduling import register_scheduling

    here = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    router = build_partitions(2)
    leaders = [APIServer(), APIServer()]
    for api in (router, *leaders):
        register_crds(api)
        register_scheduling(api)
    namespaces = [f"team-{i}" for i in range(6)]
    assert {router.owner_of(ns) for ns in namespaces} == {0, 1}
    for ns in namespaces:
        nb = {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
              "metadata": {"name": "nb", "namespace": ns},
              "spec": {"template": {"spec": {"containers": [{"name": "nb"}]}}}}
        router.create(nb)
        leaders[router.owner_of(ns)].create(nb)
    servers = [httpapi.serve(api, host="127.0.0.1", port=0) for api in (router, *leaders)]
    url_r, url_0, url_1 = (f"http://127.0.0.1:{port}" for _, port, _ in servers)
    ports = [chip_smoke.free_port(), chip_smoke.free_port()]
    cases = [
        ("comma", {"REPLICA_OF": f"{url_0},{url_1}", "PORT": str(ports[0])},
         "odh_kubeflow_tpu_torch.machinery.replica", "serving merged reads on"),
        ("router", {"REPLICA_OF": url_r, "STORE_PARTITIONS": "2", "PORT": str(ports[1])},
         "odh_kubeflow_tpu_torch.machinery.replica", "serving merged reads on"),
        ("scheduler", {"PARTITION_LEADERS": f"{url_0},{url_1}", "KUBE_API_URL": url_0,
                       "METRICS_PORT": "0", "ENABLE_SESSION_SUSPEND": "false",
                       "TRACE_EXPORT": "false"},
         "odh_kubeflow_tpu_torch.scheduling.scheduler", "gpu-scheduler running"),
    ]
    procs = {}
    try:
        for label, env, module, _ in cases:
            procs[label] = chip_smoke.start_process(
                label, ["-m", module, ], {"HOST": "127.0.0.1", **env}, str(tmp_path),
                str(tmp_path))
        for label, _, _, line in cases:
            chip_smoke.wait_line(procs[label], lambda x, line=line: line in x, 60, line)
        want = sorted(o["metadata"]["namespace"] for o in router.list("Notebook"))
        for label, port in zip(("comma", "router"), ports):
            end = time.time() + 30
            while True:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/apis/kubeflow.org/v1beta1/notebooks",
                        timeout=10) as r:
                    got = [o["metadata"]["namespace"] for o in json.loads(r.read())["items"]]
                if got == want or time.time() > end:
                    break
                time.sleep(0.05)
            assert got == want, (label, got)
        probe = subprocess.run(
            [sys.executable, "-c", "import sys, odh_kubeflow_tpu_torch.machinery.replica, "
             "odh_kubeflow_tpu_torch.scheduling.scheduler; print('torch' in sys.modules)"],
            env={**os.environ, "PYTHONPATH": here}, capture_output=True, text=True, timeout=60)
        assert probe.stdout.strip() == "False", probe.stderr
    finally:
        for p in procs.values():
            if p["proc"].poll() is None:
                p["proc"].kill()
            p["proc"].wait()
        for _, _, httpd in servers:
            httpd.shutdown()


def test_platform_apiserver_mode_serves_under_its_own_lease(tmp_path):
    """``chip_smoke.py --platform-apiserver``: ready with its URL and the
    elector's token 1, the store shipping under it; a ``report`` line
    answers with the rvs; stdin's EOF stops it with its JSON line."""
    import json
    import urllib.request

    p = chip_smoke.start_process("apiserver", [chip_smoke.__file__, "--platform-apiserver"],
                                 {"FAILOVER_ROOT": str(tmp_path)}, str(tmp_path))
    try:
        ready = chip_smoke.wait_line(p, "ready", 60, "ready")
        assert ready["token"] == 1 and ready["reference_modules"] == []
        with urllib.request.urlopen(ready["url"] + "/replication/snapshot") as r:
            cut = json.loads(r.read())
        assert cut["epoch"] == 1 and cut["rv"] > 0
        p["proc"].stdin.write("report\n")
        p["proc"].stdin.flush()
        report = chip_smoke.wait_line(p, "report", 30, "report")
        assert report["rv"] >= cut["rv"] and report["non_lease_rv"] <= report["rv"]
        p["proc"].stdin.close()
        assert p["proc"].wait(timeout=30) == 0
        p["reader"].join(timeout=10)
        last = json.loads([x for x in p["lines"] if x.startswith("{")][-1])
        assert last["token"] == 1 and last["reference_modules"] == []
    finally:
        if p["proc"].poll() is None:
            p["proc"].kill()
            p["proc"].wait()
