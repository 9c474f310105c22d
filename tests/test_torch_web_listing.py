"""The CRUD backend's listing half in the port (``web/crud_backend.py``:
the listing memo, degraded-mode serving from last-known-good rows,
``?limit=&continue=`` pages and the ``servedRv`` stamps) held to the JAX
package's, through the JWA, VWA and TWA.

The cases of ``tests/test_webtier.py`` (the memo), ``tests/test_chaos.py``
(degraded listings) and ``tests/test_fleet.py`` (pages and their 410) run
on both packages (``m``); each returns what the apps answered (statuses,
row names, row builds, degraded markers, page sizes, tokens present) and
the two records must be equal. The rows themselves differ only where the
accelerator fields do (``tpus`` against ``gpus``), so records carry names.
"""

import io
import json
import urllib.parse
import urllib.request

import pytest

from test_torch_overload import wire


def both(scenario, *args):
    return scenario(wire("jax"), *args), scenario(wire("torch"), *args)


def _nb(name, ns="team-a"):
    return {"apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"template": {"spec": {"containers": [{"name": name, "image": "j"}]}}}}


def _grant_admin(m, api, user):
    m.apis.install_default_cluster_roles(api)
    api.create({"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRoleBinding",
                "metadata": {"name": "listing-admin"},
                "subjects": [{"kind": "User", "name": user}],
                "roleRef": {"kind": "ClusterRole", "name": "kubeflow-admin"}})


def _get(app, path, query="", user="web@test"):
    environ = {"REQUEST_METHOD": "GET", "PATH_INFO": path, "QUERY_STRING": query,
               "SERVER_NAME": "t", "SERVER_PORT": "80", "wsgi.input": io.BytesIO(b""),
               "wsgi.url_scheme": "http", "HTTP_KUBEFLOW_USERID": user}
    out = {}

    def start_response(status, headers, exc_info=None):
        out["status"] = int(status.split()[0])

    body = b"".join(app(environ, start_response))
    return out["status"], json.loads(body)


# ---------------------------------------------------------------------------
# the listing memo (tests/test_webtier.py)


def _jwa_on_cache(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    m.scheduling.register_scheduling(api)
    _grant_admin(m, api, "web@test")
    cache = m.cache.InformerCache(api, kinds=("Notebook", "Workload", "Event"),
                                  registry=m.prometheus.Registry())
    cache.start(live=False)
    return api, m.jwa.JupyterWebApp(m.cache.CachedClient(api, cache))


def _rows(jwa, ns="team-a"):
    status, body = _get(jwa.app, f"/api/namespaces/{ns}/notebooks")
    assert status == 200, body
    return sorted(r["name"] for r in body["notebooks"])


def listing_memo_skips_rebuild_until_a_kind_changes(m, monkeypatch):
    api, jwa = _jwa_on_cache(m)
    api.create(_nb("memo-a"))
    builds = {"n": 0}
    real_row = m.jwa.JupyterWebApp.notebook_row

    def counting_row(self, nb, events=None):
        builds["n"] += 1
        return real_row(self, nb, events=events)

    monkeypatch.setattr(m.jwa.JupyterWebApp, "notebook_row", counting_row)
    record = [(_rows(jwa), builds["n"]), (_rows(jwa), builds["n"])]
    api.create(_nb("memo-b"))
    record.append((_rows(jwa), builds["n"]))
    api.create({"apiVersion": "v1", "kind": "Event",
                "metadata": {"name": "ev-1", "namespace": "team-a"}, "type": "Warning",
                "reason": "FailedCreate", "message": "boom",
                "involvedObject": {"kind": "Notebook", "name": "memo-a"}})
    record.append((_rows(jwa), builds["n"]))
    assert [n for _, n in record] == [1, 1, 3, 5]
    return record


def listing_memo_disabled_without_a_versioned_cache(m, monkeypatch):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    _grant_admin(m, api, "web@test")
    jwa = m.jwa.JupyterWebApp(api)
    api.create(_nb("plain-a"))
    first = _rows(jwa)
    api.create(_nb("plain-b"))
    return first, _rows(jwa), jwa._listing_memo


# ---------------------------------------------------------------------------
# degraded listings (tests/test_chaos.py)


def _injector(m, api, registry=None):
    return m.faults.FaultInjector(api, seed=11, schedule=m.faults.FaultSchedule.none(),
                                  registry=registry or m.prometheus.Registry(),
                                  sleep_fn=lambda s: None)


def serve_listing_last_known_good_without_cache(m, monkeypatch):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    inj = _injector(m, api)
    jwa = m.jwa.JupyterWebApp(inj)
    api.create(_nb("nb"))

    def build():
        return [jwa.notebook_row(nb)["name"] for nb in jwa.api.list("Notebook",
                                                                     namespace="team-a")]

    healthy = jwa.serve_listing(("notebooks", "team-a"), build)
    inj.set_offline(True)
    outage = jwa.serve_listing(("notebooks", "team-a"), build)
    never = jwa.serve_listing(("pvcs", "team-a"),
                              lambda: jwa.api.list("PersistentVolumeClaim", namespace="team-a"))
    inj.set_offline(False)
    with pytest.raises(m.store.NotFound):
        jwa.serve_listing(("bad", "team-a"),
                          lambda: jwa.api.list("NoSuchKind", namespace="team-a"))
    assert healthy == (["nb"], False) and outage == (["nb"], True) and never == ([], True)
    return healthy, outage, never


def web_listings_degrade_instead_of_500(m, monkeypatch):
    monkeypatch.setattr(m.crud_backend, "DEV_MODE", True)
    api = m.store.APIServer()
    m.apis.register_crds(api)
    m.scheduling.register_scheduling(api)
    registry = m.prometheus.Registry()
    inj = _injector(m, api, registry)
    cache = m.cache.InformerCache(
        inj, kinds=("Notebook", "Tensorboard", "PersistentVolumeClaim", "Pod", "StatefulSet",
                    "Workload", "Event", "Node", "ResourceQuota"), registry=registry)
    m.cache.register_platform_indexers(cache)
    cache.reestablish_backoff = 0.0
    cache.start(live=False)
    client = m.cache.CachedClient(inj, cache)
    servers = []

    def up(app_obj):
        httpd = app_obj.app.serve("127.0.0.1", 0)
        servers.append(httpd)
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    bases = {"jwa": up(m.jwa.JupyterWebApp(client)), "vwa": up(m.vwa.VolumesWebApp(client)),
             "twa": up(m.twa.TensorboardsWebApp(client))}
    paths = {"jwa": ("/api/namespaces/team-a/notebooks", "notebooks"),
             "vwa": ("/api/namespaces/team-a/pvcs", "pvcs"),
             "twa": ("/api/namespaces/team-a/tensorboards", "tensorboards")}

    def get(app):
        path, field = paths[app]
        req = urllib.request.Request(bases[app] + path,
                                     headers={"kubeflow-userid": "alice@example.com"})
        with urllib.request.urlopen(req, timeout=5) as r:
            body = json.loads(r.read().decode())
            return r.status, bool(body.get("degraded")), sorted(x["name"] for x in body[field])

    try:
        api.create(_nb("nb1"))
        api.create({"apiVersion": "v1", "kind": "PersistentVolumeClaim",
                    "metadata": {"name": "vol1", "namespace": "team-a"},
                    "spec": {"resources": {"requests": {"storage": "1Gi"}}}})
        api.create({"apiVersion": "tensorboard.kubeflow.org/v1alpha1", "kind": "Tensorboard",
                    "metadata": {"name": "tb1", "namespace": "team-a"},
                    "spec": {"logspath": "pvc://vol1/logs"}})
        healthy = {app: get(app) for app in paths}
        inj.set_offline(True)
        api.create(_nb("nb2"))
        outage = {app: get(app) for app in paths}
        inj.set_offline(False)
        healed = get("jwa")
    finally:
        for httpd in servers:
            httpd.shutdown()
    assert all(v[:2] == (200, False) for v in healthy.values())
    assert all(v[:2] == (200, True) and v[2] == healthy[a][2] for a, v in outage.items())
    assert healed == (200, False, ["nb1", "nb2"]) and cache.m_relists.value() >= 1
    return healthy, outage, healed


# ---------------------------------------------------------------------------
# pages (tests/test_fleet.py)


def _jwa_fixture(m):
    api = m.store.APIServer()
    m.apis.register_crds(api)
    _grant_admin(m, api, "web@test")
    api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "team"}})
    for i in range(7):
        api.create(_nb(f"nb-{i}", "team"))
    return api, m.jwa.JupyterWebApp(api)


def jwa_listing_paginates_with_continue_tokens(m, monkeypatch):
    api, jwa = _jwa_fixture(m)
    pages, query = [], "limit=3"
    while True:
        status, body = _get(jwa.app, "/api/namespaces/team/notebooks", query)
        assert status == 200
        pages.append([r["name"] for r in body["notebooks"]])
        token = body.get("continue", "")
        if not token:
            break
        query = "limit=3&continue=" + urllib.parse.quote(token, safe="")
    assert sorted(sum(pages, [])) == [f"nb-{i}" for i in range(7)]
    status, body = _get(jwa.app, "/api/namespaces/team/notebooks")
    assert status == 200 and len(body["notebooks"]) == 7 and "continue" not in body
    bad = _get(jwa.app, "/api/namespaces/team/notebooks", "limit=x")[0]
    return pages, sorted(body), bad


def jwa_continue_token_goes_410_when_listing_changes(m, monkeypatch):
    api, jwa = _jwa_fixture(m)
    status, body = _get(jwa.app, "/api/namespaces/team/notebooks", "limit=2")
    token = body["continue"]
    api.create(_nb("nb-late", "team"))
    status, body = _get(jwa.app, "/api/namespaces/team/notebooks",
                        "limit=2&continue=" + urllib.parse.quote(token, safe=""))
    assert status == 410 and body["success"] is False
    return status, sorted(body)


@pytest.mark.parametrize("scenario", [
    listing_memo_skips_rebuild_until_a_kind_changes,
    listing_memo_disabled_without_a_versioned_cache,
    serve_listing_last_known_good_without_cache,
    web_listings_degrade_instead_of_500,
    jwa_listing_paginates_with_continue_tokens,
    jwa_continue_token_goes_410_when_listing_changes,
], ids=lambda f: f.__name__)
def test_web_listing_scenario_equal_on_both(scenario, monkeypatch):
    jax_rec, torch_rec = both(scenario, monkeypatch)
    assert torch_rec == jax_rec


def test_served_rv_stamps_from_a_partitioned_follower():
    """``listing_body`` stamps ``servedRv`` and ``servedRvPartitions`` from
    the backing read replica. In-process (a ``ReadSplitAPI`` over a
    partitioned router) both packages stamp the same; over HTTP the
    port's remote client mirrors the façade's ``X-Served-RV-Partitions``
    header, so a split app carries the vector too (JAX's client carries
    the scalar alone)."""
    stamps = []
    for name in ("jax", "torch"):
        m = wire(name)
        router = m.partition.build_partitions(3)
        m.apis.register_crds(router)
        _grant_admin(m, router, "web@test")
        for i in range(6):
            router.create(_nb(f"nb-{i}", f"team-{i}"))
        split = m.replica.ReadSplitAPI(router, router)
        jwa = m.jwa.JupyterWebApp(split)
        status, body = _get(jwa.app, "/api/namespaces/team-1/notebooks")
        assert status == 200
        stamps.append((body["servedRv"], body["servedRvPartitions"]))
        _t, port, srv = m.httpapi.serve(router, host="127.0.0.1", port=0)
        try:
            remote = m.client.RemoteAPIServer(f"http://127.0.0.1:{port}")
            m.apis.register_crds(remote)
            remote_jwa = m.jwa.JupyterWebApp(remote)
            status, body = _get(remote_jwa.app, "/api/namespaces/team-1/notebooks", "limit=1")
            assert status == 200
            stamps.append((body["servedRv"], body.get("servedRvPartitions")))
        finally:
            srv.shutdown()
    assert stamps[0] == stamps[2]
    want = {str(p): rv for p, rv in router.applied_rvs().items()}
    assert stamps[2] == (sum(router.applied_rvs().values()), want)
    assert stamps[1] == (stamps[0][0], None)  # JAX's remote client: the scalar alone
    assert stamps[3] == stamps[0]
