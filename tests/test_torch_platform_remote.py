"""The pieces of ``chip_smoke.py``'s ``platform_remote`` phase on the CPU,
without the card: the apiserver served by this test (the store with a
write-ahead log, the REST façade over TLS with bearer tokens, the
admission webhooks, the JWA) and ``chip_smoke.py --platform-controllers``
as a real subprocess, a client of ``api_from_env()``. A notebook POSTed
through the JWA reaches a Running pod over the wire, and its trace
assembles into one tree from both processes through the ingest route.
The notebook's own process (its serve is on the card) is left out.
Watches over TLS take no thread each, and the flood's plan and schedule
are seeded and paced as the phase needs them.
"""

import chip_smoke as cs


def test_controller_process_spawns_over_tls_and_the_trace_is_one_tree(tmp_path):
    fleet = cs.remote_apiserver(str(tmp_path))
    ctl = cs.start_remote_process(fleet, "--platform-controllers", {}, "controller")
    try:
        assert ctl["ready"].wait(120) and "ready" in ctl["events"], open(ctl["err"]).read()
        ns = cs.REMOTE_NAMESPACES[0]
        posted = cs.remote_post(fleet, ns, "nb-cpu")
        running = cs.wait_running(fleet["api"], ns, "nb-cpu")
        assert running > posted
        trace = cs.remote_trace(fleet, ns, "nb-cpu")
        assert trace["root"].startswith("jupyter-web-app:POST")
        assert trace["tree_nodes"] == trace["spans"] and trace["causal_order"]
        # the controller process's spans came through the ingest route:
        # this process runs no controller, scheduler or kubelet
        assert trace["ingested"] >= 3 and trace["apiserver_spans"] >= 1
        env, node = cs.pod_process_env(fleet["api"], "nb-cpu", ns, str(tmp_path / "ws"))
        assert node.startswith(cs.REMOTE_POOL[0])
        assert env["ODH_TORCH_KERNEL_CACHE"].startswith(str(tmp_path / "ws"))
        out = cs.stop_remote_process(ctl)
        ctl = None
        assert out["reference_modules"] == []
        assert out["kubelet_step_errors"] == 0 and out["spans_dropped"] == 0
        assert out["spans_shipped"] >= trace["ingested"]
        # every controller-level request was admitted
        assert not any(k.startswith("controller/") for k in cs.shed_counts(fleet["registry"]))
    finally:
        if ctl is not None and ctl["proc"].poll() is None:
            ctl["proc"].kill()
            ctl["proc"].wait()
        fleet["close"]()


def test_flood_plan_is_seeded():
    a = cs.remote_flood_plan(cs.REMOTE_SEED, 2000)
    assert a == cs.remote_flood_plan(cs.REMOTE_SEED, 2000)
    assert a != cs.remote_flood_plan(cs.REMOTE_SEED + 1, 2000)
    expired = sum(e for *_, e in a) / len(a)
    writes = sum(op == "patch" for op, *_ in a) / len(a)
    assert abs(expired - cs.REMOTE_EXPIRED_SHARE) < 0.02
    # one expired request in each block, at a seeded place
    block = round(1 / cs.REMOTE_EXPIRED_SHARE)
    assert all(sum(e for *_, e in a[k:k + block]) == 1 for k in range(0, len(a), block))
    assert len({[e for *_, e in a[k:k + block]].index(True)
                for k in range(0, len(a), block)}) > 1
    assert abs(writes - cs.REMOTE_WRITE_SHARE) < 0.03
    assert {ns for _, ns, _, _ in a} == set(cs.REMOTE_NAMESPACES)
    sched = cs.flood_schedule()
    assert [s[0] for s in sched[:2]] == ["baseline", "flood"]
    assert sched[1][1] == 4 * cs.REMOTE_INFLIGHT_LIMIT
    assert sum(s[3] for s in sched[2:]) == cs.REMOTE_RECOVERY_S
    # the baseline's and the recovery's users are paced under the limit,
    # the flood's send back to back
    assert [s[4] for s in sched] == [cs.REMOTE_USER_PERIOD_S, None] + [
        cs.REMOTE_USER_PERIOD_S] * (len(sched) - 2)


def test_watches_over_tls_take_no_thread_each(tmp_path):
    fleet = cs.remote_apiserver(str(tmp_path))
    try:
        record = cs.remote_watches(fleet, n=100)
    finally:
        fleet["close"]()
    assert record["live"] == 100 and record["store_watchers_left"] == 0
    assert record["threads_added"] < cs.REMOTE_WATCH_THREADS_GATE
