"""The port's REST façade (``machinery/httpapi.py``) and its remote client
(``machinery/client.py``) held to the JAX package's.

The counterparts of ``tests/test_httpapi.py``, ``tests/test_client_auth.py``
and ``tests/test_auth_proxy.py`` run on both packages (``m``). The
store's paged lists are held to JAX's store page by page, and one seeded
script of requests goes through both packages' ``RestAPI`` as WSGI apps
(no socket): statuses, ``Retry-After``, ``Content-Type`` and bodies must
agree once JAX's names go through ``apis.ACCELERATOR_MAPPING`` and uids
and timestamps are masked.

The remote reconcile tests wait for the Service as they wait for the
StatefulSet: the controller writes the two in turn, so reading the
Service the moment the StatefulSet appears races the controller.
"""

import io
import json
import os
import pathlib
import random
import re
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from test_torch_overload import wire

REPO = pathlib.Path(__file__).resolve().parent.parent
PROXY = REPO / "images" / "auth-proxy" / "auth-proxy"
TOKEN = "sa-token-abc123"
ROTATED = "sa-token-rotated456"


@pytest.fixture(params=["jax", "torch"])
def m(request):
    mods = wire(request.param)
    mods.overload._reset_shared_budget_for_tests()
    yield mods
    mods.overload._reset_shared_budget_for_tests()


def _notebook(name="nb1", ns="team-a"):
    return {
        "apiVersion": "kubeflow.org/v1beta1",
        "kind": "Notebook",
        "metadata": {"name": name, "namespace": ns, "labels": {"app": name}},
        "spec": {"template": {"spec": {"containers": [{"name": name, "image": "jupyter:x"}]}}},
    }


def _wait_get(client, m, kind, name, ns, seconds=10.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            return client.get(kind, name, ns)
        except m.store.NotFound:
            time.sleep(0.05)
    raise AssertionError(f"{kind} {ns}/{name} never appeared")


# ---------------------------------------------------------------------------
# tests/test_httpapi.py


@pytest.fixture()
def served(m):
    server = m.store.APIServer()
    m.apis.register_crds(server)
    _, port, httpd = m.httpapi.serve(server)
    client = m.client.RemoteAPIServer(f"http://127.0.0.1:{port}",
                                      registry=m.prometheus.Registry())
    m.apis.register_crds(client)
    yield server, client
    httpd.shutdown()


def test_crud_roundtrip(m, served):
    _, client = served
    created = client.create(_notebook())
    assert created["metadata"]["uid"]
    got = client.get("Notebook", "nb1", "team-a")
    assert got["spec"]["template"]["spec"]["containers"][0]["image"] == "jupyter:x"
    assert len(client.list("Notebook", namespace="team-a")) == 1
    assert client.list("Notebook", "team-a", label_selector={"matchLabels": {"app": "nb1"}})
    assert client.list("Notebook", "team-a",
                       label_selector={"matchLabels": {"app": "zz"}}) == []
    patched = client.patch("Notebook", "nb1", {"metadata": {"annotations": {"x": "y"}}},
                           "team-a")
    assert patched["metadata"]["annotations"]["x"] == "y"
    got = client.get("Notebook", "nb1", "team-a")
    got["status"] = {"readyReplicas": 1}
    assert client.update_status(got)["status"]["readyReplicas"] == 1
    client.delete("Notebook", "nb1", "team-a")
    with pytest.raises(m.store.NotFound):
        client.get("Notebook", "nb1", "team-a")


def test_error_mapping(m, served):
    _, client = served
    client.create(_notebook())
    with pytest.raises(m.store.AlreadyExists):
        client.create(_notebook())
    with pytest.raises(m.store.NotFound):
        client.get("Notebook", "missing", "team-a")
    bad = _notebook("bad")
    bad["spec"]["template"]["spec"]["containers"] = []
    with pytest.raises(m.store.Invalid):
        client.create(bad)
    a = client.get("Notebook", "nb1", "team-a")
    b = client.get("Notebook", "nb1", "team-a")
    a["metadata"]["annotations"] = {"v": "1"}
    client.update(a)
    b["metadata"]["annotations"] = {"v": "2"}
    with pytest.raises(m.store.Conflict):
        client.update(b)


def test_dry_run_create(m, served):
    server, client = served
    client.create(_notebook("dry"), dry_run=True)
    assert server.list("Notebook", namespace="team-a") == []


def test_watch_stream(m, served):
    _, client = served
    w = client.watch("Notebook", namespace="team-a", send_initial=False)
    time.sleep(0.2)
    client.create(_notebook("w1"))
    etype, obj = w.get(timeout=5)
    assert (etype, obj["metadata"]["name"]) == ("ADDED", "w1")
    client.patch("Notebook", "w1", {"metadata": {"annotations": {"a": "b"}}}, "team-a")
    assert w.get(timeout=5)[0] == "MODIFIED"
    client.delete("Notebook", "w1", "team-a")
    assert w.get(timeout=5)[0] == "DELETED"
    w.stop()


def test_remote_reconcile_loop(m, served):
    _, client = served
    mgr = m.runtime.Manager(client)
    m.notebook.NotebookController(client, m.notebook.NotebookControllerConfig()).register(mgr)
    mgr.start()
    try:
        client.create(_notebook("remote"))
        _wait_get(client, m, "StatefulSet", "remote", "team-a")
        svc = _wait_get(client, m, "Service", "remote", "team-a")
        assert svc["spec"]["ports"][0]["port"] == 80
    finally:
        mgr.stop()


def test_put_body_must_match_url(m, served):
    _, client = served
    client.create(_notebook("x"))
    client.create(_notebook("y"))
    got = client.get("Notebook", "x", "team-a")
    got["metadata"]["name"] = "y"
    got["metadata"]["annotations"] = {"v": "hijack"}
    with pytest.raises((m.store.Conflict, m.store.BadRequest)):
        client.update(got)
    fresh_y = client.get("Notebook", "y", "team-a")
    assert fresh_y["metadata"].get("annotations", {}).get("v") != "hijack"
    url = client.base_url + "/apis/kubeflow.org/v1beta1/namespaces/team-a/notebooks/x"
    req = urllib.request.Request(url, data=json.dumps(fresh_y).encode(), method="PUT",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400


def test_put_defaults_namespace_from_url(m, served):
    _, client = served
    client.create(_notebook("nsless"))
    got = client.get("Notebook", "nsless", "team-a")
    del got["metadata"]["namespace"]
    got["metadata"]["annotations"] = {"via": "put"}
    url = client.base_url + "/apis/kubeflow.org/v1beta1/namespaces/team-a/notebooks/nsless"
    req = urllib.request.Request(url, data=json.dumps(got).encode(), method="PUT",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 200
    assert client.get("Notebook", "nsless", "team-a")["metadata"]["annotations"]["via"] == "put"


def test_patch_cannot_rename(m, served):
    _, client = served
    client.create(_notebook("p1"))
    with pytest.raises(m.store.BadRequest):
        client.patch("Notebook", "p1", {"metadata": {"name": "p2"}}, "team-a")


def test_label_selector_encoding_and_expressions(m, served):
    _, client = served
    nb = _notebook("sel")
    nb["metadata"]["labels"] = {"app": "sel", "tier": "a b&c"}
    client.create(nb)
    names = lambda got: [o["metadata"]["name"] for o in got]  # noqa: E731
    assert names(client.list("Notebook", "team-a",
                             label_selector={"matchLabels": {"tier": "a b&c"}})) == ["sel"]
    assert names(client.list("Notebook", "team-a", label_selector={
        "matchExpressions": [{"key": "app", "operator": "Exists"}]})) == ["sel"]
    assert names(client.list("Notebook", "team-a", label_selector={
        "matchExpressions": [{"key": "app", "operator": "NotIn", "values": ["other"]}]})) == [
        "sel"]
    with pytest.raises(ValueError):
        client.list("Notebook", "team-a", label_selector={
            "matchExpressions": [{"key": "app", "operator": "In", "values": ["a", "b"]}]})


def test_client_pages_its_lists(m, served):
    """A page size walks the collection in chunks through continue
    tokens (``KUBE_LIST_PAGE_SIZE``'s client-go pager), giving the same
    items as one unpaginated list."""
    server, client = served
    for i in range(7):
        server.create(_notebook(f"pg-{i}"))
    client.page_size = 3
    paged = client.list("Notebook", namespace="team-a")
    client.page_size = None
    assert [o["metadata"]["name"] for o in paged] == [f"pg-{i}" for i in range(7)]
    assert sorted(paged, key=lambda o: o["metadata"]["name"]) == sorted(
        client.list("Notebook", namespace="team-a"), key=lambda o: o["metadata"]["name"])
    assert len(client.list("Notebook", namespace="team-a", limit=2)) == 2


def test_api_from_env_builds_a_fanout_over_several_urls():
    """The comma-separated form, like the JAX package's, builds a
    ReplicaFanout over one client per URL."""
    from odh_kubeflow_tpu_torch.machinery.client import ReplicaFanout, api_from_env

    api = api_from_env("http://127.0.0.1:1, http://127.0.0.1:2")
    assert isinstance(api, ReplicaFanout)
    assert [c.base_url for c in api.clients] == [
        "http://127.0.0.1:1",
        "http://127.0.0.1:2",
    ]


# ---------------------------------------------------------------------------
# tests/test_client_auth.py


@pytest.fixture(scope="module")
def tls_materials(tmp_path_factory):
    from odh_kubeflow_tpu_torch.webhooks.certs import generate_webhook_certs

    d = tmp_path_factory.mktemp("apiserver-tls")
    bundle = generate_webhook_certs(dns_names=["localhost"], ip_sans=["127.0.0.1"])
    cert_path, key_path, ca_path = bundle.write(str(d))
    token_auth_file = d / "tokens.csv"
    token_auth_file.write_text(
        f"{TOKEN},system:serviceaccount:kubeflow:notebook-controller,uid1\n"
        f'{ROTATED},system:serviceaccount:kubeflow:notebook-controller,uid1,"system:masters"\n'
    )
    return {"cert": cert_path, "key": key_path, "ca": ca_path,
            "token_auth_file": str(token_auth_file)}


@pytest.fixture()
def tls_served(m, tls_materials):
    server = m.store.APIServer()
    m.apis.register_crds(server)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(tls_materials["cert"], tls_materials["key"])
    authenticator = m.httpapi.TokenAuthenticator.from_file(tls_materials["token_auth_file"])
    _, port, httpd = m.httpapi.serve(server, ssl_context=ctx, authenticator=authenticator)
    yield server, port
    httpd.shutdown()


def _tls_client(m, tls_materials, port, **kw):
    kw.setdefault("ca_file", tls_materials["ca"])
    kw.setdefault("registry", m.prometheus.Registry())
    c = m.client.RemoteAPIServer(f"https://127.0.0.1:{port}", **kw)
    m.apis.register_crds(c)
    return c


def test_anonymous_and_bad_token_rejected(m, tls_materials, tls_served):
    _, port = tls_served
    with pytest.raises(m.store.Unauthorized):
        _tls_client(m, tls_materials, port).list("Notebook", namespace="team-a")
    with pytest.raises(m.store.Unauthorized):
        _tls_client(m, tls_materials, port, token="wrong-token").get("Notebook", "nb1", "team-a")


def test_health_probes_stay_anonymous(m, tls_materials, tls_served):
    _, port = tls_served
    ctx = ssl.create_default_context(cafile=tls_materials["ca"])
    with urllib.request.urlopen(f"https://127.0.0.1:{port}/healthz", context=ctx) as r:
        assert r.read() == b"ok"


def test_remote_reconcile_over_tls_with_token(m, tls_materials, tls_served):
    _, port = tls_served
    client = _tls_client(m, tls_materials, port, token=TOKEN)
    mgr = m.runtime.Manager(client)
    m.notebook.NotebookController(client, m.notebook.NotebookControllerConfig()).register(mgr)
    mgr.start()
    try:
        client.create(_notebook("secure-nb"))
        _wait_get(client, m, "StatefulSet", "secure-nb", "team-a")
        svc = _wait_get(client, m, "Service", "secure-nb", "team-a")
        assert svc["spec"]["ports"][0]["port"] == 80
    finally:
        mgr.stop()


def test_token_file_rotation(m, tls_materials, tls_served, tmp_path):
    _, port = tls_served
    token_file = tmp_path / "token"
    token_file.write_text(TOKEN)
    client = _tls_client(m, tls_materials, port, token_file=str(token_file))
    client.create(_notebook("rotate-nb"))
    token_file.write_text("no-longer-valid")
    os.utime(token_file, (time.time() + 2, time.time() + 2))
    with pytest.raises(m.store.Unauthorized):
        client.get("Notebook", "rotate-nb", "team-a")
    token_file.write_text(ROTATED)
    os.utime(token_file, (time.time() + 4, time.time() + 4))
    assert client.get("Notebook", "rotate-nb", "team-a")["metadata"]["name"] == "rotate-nb"


def test_api_from_env_in_cluster_discovery(m, tls_materials, tls_served, tmp_path,
                                           monkeypatch):
    _, port = tls_served
    sa = tmp_path / "serviceaccount"
    sa.mkdir()
    (sa / "token").write_text(TOKEN)
    (sa / "ca.crt").write_bytes(open(tls_materials["ca"], "rb").read())
    (sa / "namespace").write_text("kubeflow")
    monkeypatch.delenv("KUBE_API_URL", raising=False)
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(port))
    monkeypatch.setenv("KUBE_SA_DIR", str(sa))
    monkeypatch.setenv("KUBE_API_QPS", "50")
    api = m.client.api_from_env()
    assert api.base_url == f"https://127.0.0.1:{port}"
    api.create(_notebook("incluster-nb"))
    assert api.get("Notebook", "incluster-nb", "team-a")["metadata"]["name"] == "incluster-nb"


# ---------------------------------------------------------------------------
# tests/test_auth_proxy.py: the auth-proxy sidecar authorizing through
# the façade's SubjectAccessReview route


class EchoUpstream(BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({"path": self.path,
                           "user": self.headers.get("kubeflow-userid", "")}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def stack(m, tmp_path):
    import wsgiref.simple_server

    api = m.store.APIServer()
    m.apis.register_crds(api)
    m.apis.install_default_cluster_roles(api)
    api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "team-a"}})
    api.create({
        "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
        "metadata": {"name": "alice-edit", "namespace": "team-a"},
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "ClusterRole",
                    "name": "kubeflow-edit"},
        "subjects": [{"kind": "User", "name": "alice@example.com"}],
    })
    api_httpd = wsgiref.simple_server.make_server("127.0.0.1", 0, m.httpapi.RestAPI(api))
    upstream = HTTPServer(("127.0.0.1", 0), EchoUpstream)
    for srv in (api_httpd, upstream):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    nb = {
        "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
        "metadata": {"name": "nb1", "namespace": "team-a",
                     "annotations": {"notebooks.opendatahub.io/inject-oauth": "true"}},
        "spec": {"template": {"spec": {"containers": [{"name": "nb1", "image": "x"}]}}},
    }
    mutated = m.nb_webhook.NotebookWebhook(api).mutate(
        m.store.AdmissionRequest("CREATE", nb, None, False))
    sidecar = next(c for c in mutated["spec"]["template"]["spec"]["containers"]
                   if c["name"] == "auth-proxy")
    cookie_file = tmp_path / "secret"
    cookie_file.write_bytes(b"s3cret")
    args = []
    for a in sidecar["args"]:
        a = a.replace("--upstream=http://localhost:8888",
                      f"--upstream=http://127.0.0.1:{upstream.server_address[1]}")
        a = a.replace("--https-address=:8443", "--https-address=127.0.0.1:0")
        a = a.replace("--cookie-secret-file=/etc/auth/cookie/secret",
                      f"--cookie-secret-file={cookie_file}")
        a = a.replace("/etc/tls/private/tls.crt", str(tmp_path / "no.crt"))
        a = a.replace("/etc/tls/private/tls.key", str(tmp_path / "no.key"))
        args.append(a)
    args.append(f"--api-url=http://127.0.0.1:{api_httpd.server_address[1]}")
    proc = subprocess.Popen([sys.executable, str(PROXY), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()
    found = re.search(r"http://127\.0\.0\.1:(\d+)", line)
    assert found, f"proxy did not start: {line!r}"
    yield {"base": f"http://127.0.0.1:{found.group(1)}"}
    proc.terminate()
    proc.wait(timeout=5)
    api_httpd.shutdown()
    upstream.shutdown()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.getcode(), r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_ping_unauthenticated(stack):
    code, body, _ = _get(f"{stack['base']}/ping")
    assert code == 200 and body == b"OK"


def test_no_identity_401(stack):
    assert _get(f"{stack['base']}/lab")[0] == 401


def test_unauthorized_user_403(stack):
    code, body, _ = _get(f"{stack['base']}/lab",
                         headers={"kubeflow-userid": "mallory@example.com"})
    assert code == 403 and b"not authorized" in body


def test_authorized_user_proxied_and_session_cookie(stack):
    code, body, headers = _get(f"{stack['base']}/lab/tree?x=1",
                               headers={"kubeflow-userid": "alice@example.com"})
    assert code == 200
    seen = json.loads(body.decode())
    assert seen == {"path": "/lab/tree?x=1", "user": "alice@example.com"}
    cookie = headers.get("Set-Cookie", "").split(";")[0]
    assert cookie.startswith("auth-proxy-session=")
    code, body, _ = _get(f"{stack['base']}/lab", headers={"Cookie": cookie})
    assert code == 200 and json.loads(body.decode())["user"] == "alice@example.com"
    forged = "auth-proxy-session=bob@example.com|" + "0" * 64
    assert _get(f"{stack['base']}/lab", headers={"Cookie": forged})[0] == 401


# ---------------------------------------------------------------------------
# the store's paged lists against JAX's store


def _paged_walk(store_mod, apis_mod, seed: int) -> list:
    rng = random.Random(seed)
    api = store_mod.APIServer()
    apis_mod.register_crds(api)
    out = []
    for i in range(40):
        ns = rng.choice(("team-a", "team-b", "team-c"))
        nb = _notebook(f"nb-{rng.randrange(1000):03d}-{i}", ns)
        nb["metadata"]["labels"]["tier"] = rng.choice(("x", "y"))
        api.create(nb)
    for ns in (None, "team-a", "team-b"):
        for limit in (1, 3, 7, 100):
            for selector in (None, {"tier": "x"}):
                token, pages = None, []
                while True:
                    items, token = api.list_chunk("Notebook", namespace=ns,
                                                  label_selector=selector, limit=limit,
                                                  continue_token=token)
                    pages.append([(o["metadata"].get("namespace"), o["metadata"]["name"],
                                   o["metadata"]["resourceVersion"]) for o in items])
                    if not token:
                        break
                out.append((ns, limit, selector, pages))
    # a token for another namespace and garbage are 400s
    _, token = api.list_chunk("Notebook", namespace="team-a", limit=1)
    for bad_ns, bad_token in (("team-b", token), ("team-a", "!!garbage")):
        with pytest.raises(store_mod.BadRequest):
            api.list_chunk("Notebook", namespace=bad_ns, limit=1, continue_token=bad_token)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_list_chunk_pages_match_jax(seed):
    jax, port = wire("jax"), wire("torch")
    assert _paged_walk(port.store, port.apis, seed) == _paged_walk(jax.store, jax.apis, seed)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_list_chunk_token_past_the_compacted_window_is_410(pkg):
    mods = wire(pkg)
    api = mods.store.APIServer()
    mods.apis.register_crds(api)
    api.WATCH_CACHE_SIZE = 4
    for i in range(5):
        api.create(_notebook(f"c-{i}"))
    items, token = api.list_chunk("Notebook", namespace="team-a", limit=2)
    assert len(items) == 2 and token
    for i in range(8):  # churn compacts the watch cache past the token's rv
        api.patch("Notebook", "c-0", {"metadata": {"annotations": {"n": str(i)}}}, "team-a")
    with pytest.raises(mods.store.Expired):
        api.list_chunk("Notebook", namespace="team-a", limit=2, continue_token=token)
    # the pager restarts from a fresh list
    calls = []

    def chunk(kind, limit, continue_token):
        calls.append(continue_token)
        if continue_token == "stale":
            raise mods.store.Expired("gone")
        return (["a"], "stale") if len(calls) == 1 else (["a", "b"], "")

    assert mods.store.paged_list_all(chunk, "Notebook", 2, lambda: ["fallback"]) == ["a", "b"]


# ---------------------------------------------------------------------------
# one seeded request script through both façades as WSGI apps

_MASK = re.compile(
    r'("(?:uid|creationTimestamp|deletionTimestamp|lastTimestamp|firstTimestamp)": )"[^"]*"')
_VERSION = '{"gitVersion": "odh-kubeflow-tpu'


def _to_gpu(text: str) -> str:
    from odh_kubeflow_tpu_torch.apis import ACCELERATOR_MAPPING

    for tpu, gpu in sorted(ACCELERATOR_MAPPING.items(), key=lambda kv: -len(kv[0])):
        if not tpu.isalpha():
            text = text.replace(tpu, gpu)
    return text


def _wsgi(app, method, path, body=None, headers=None):
    raw = b"" if body is None else json.dumps(body).encode()
    environ = {"REQUEST_METHOD": method, "PATH_INFO": path.partition("?")[0],
               "QUERY_STRING": path.partition("?")[2], "CONTENT_LENGTH": str(len(raw)),
               "CONTENT_TYPE": "application/json", "wsgi.input": io.BytesIO(raw),
               "REMOTE_ADDR": "127.0.0.1"}
    for k, v in (headers or {}).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    state = {}

    def start_response(status, hdrs, exc_info=None):
        state["status"], state["headers"] = status, dict(hdrs)

    result = app(environ, start_response)
    if result.__class__.__name__ == "WatchBody":
        frames = []
        it = iter(result)
        frames.append(next(it))  # the greeting
        while True:
            item = result.watch.try_get()
            if item is None:
                break
            frames.append(result.frame(item))
        result.close()
        payload = b"".join(frames)
    else:
        payload = b"".join(result)
    return (state["status"].split()[0], state["headers"].get("Retry-After"),
            state["headers"].get("Content-Type"), payload.decode())


def _wsgi_script(seed: int) -> list:
    """~40 requests: CRUD, every error code the façade maps, dry-run,
    selectors, paged lists, expired and malformed deadlines, watch
    frames, an over-limit request and the SubjectAccessReview route."""
    rng = random.Random(seed)
    nbs = [f"nb-{rng.randrange(100):02d}-{i}" for i in range(5)]
    tpu_pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "tpu-pod", "namespace": "team-a",
                            "labels": {"cloud.google.com/gke-tpu-accelerator": "v5e"}},
               "spec": {"containers": [{"name": "c", "image": "x", "resources": {
                   "limits": {"google.com/tpu": "4"}}}]}}
    nb_path = "/apis/kubeflow.org/v1beta1/namespaces/team-a/notebooks"
    script = [("GET", "/healthz", None, None), ("GET", "/nope", None, None),
              ("GET", "/api/v1/namespaces/team-a/widgets", None, None)]
    for name in nbs:
        nb = _notebook(name)
        nb["metadata"]["labels"]["tier"] = rng.choice(("x", "y"))
        script.append(("POST", nb_path, nb, None))
    script += [
        ("POST", nb_path, _notebook(nbs[0]), None),  # 409 AlreadyExists
        ("POST", nb_path + "?dryRun=All", _notebook("dry"), None),
        ("GET", nb_path + "/dry", None, None),  # 404
        ("POST", nb_path, {**_notebook("bad"), "spec": {"template": {"spec": {
            "containers": []}}}}, None),  # 422
        ("GET", nb_path + f"/{nbs[1]}", None, None),
        ("GET", nb_path + "?labelSelector=tier%3Dx", None, None),
        ("GET", nb_path + "?labelSelector=tier%21%3Dx", None, None),
        ("GET", nb_path + "?limit=2", None, None),
        ("GET", "/apis/kubeflow.org/v1beta1/notebooks?limit=0", None, None),
        ("GET", nb_path + "?limit=abc", None, None),  # 422
        ("GET", nb_path + "?limit=2&continue=%21%21", None, None),  # 400
        ("PATCH", nb_path + f"/{nbs[2]}", {"metadata": {"annotations": {"a": "b"}}}, None),
        ("PATCH", nb_path + f"/{nbs[2]}", {"metadata": {"name": "other"}}, None),  # 400
        ("PUT", nb_path + f"/{nbs[3]}", {**_notebook(nbs[4])}, None),  # 400 mismatch
        ("PUT", nb_path + f"/{nbs[3]}", {**_notebook(nbs[3]), "metadata": {
            "name": nbs[3], "namespace": "team-a", "resourceVersion": "1"}}, None),  # 409
        ("PUT", nb_path + f"/{nbs[3]}/status", {**_notebook(nbs[3]), "metadata": {
            "name": nbs[3], "namespace": "team-a"}, "status": {"readyReplicas": 1}}, None),
        ("DELETE", nb_path + f"/{nbs[4]}", None, None),
        ("DELETE", nb_path + f"/{nbs[4]}", None, None),  # 404
        ("POST", nb_path + "/x", _notebook("x"), None),  # 422 unsupported
        ("GET", nb_path, None, {"X-Request-Deadline": "0"}),  # 504
        ("GET", nb_path, None, {"X-Request-Deadline": "-1"}),  # 504
        ("GET", nb_path, None, {"X-Request-Deadline": "soon"}),  # 400
        ("GET", nb_path, None, {"X-Request-Deadline": "30"}),
        ("POST", "/api/v1/namespaces/team-a/pods", tpu_pod, None),
        ("GET", "/api/v1/namespaces/team-a/pods/tpu-pod", None, None),
        ("GET", "/api/v1/pods", None, None),
        ("GET", "/api/v1/namespaces/team-a/pods?watch=true", None, None),
        ("GET", nb_path + "?watch=true&sendInitialEvents=false", None, None),
        ("GET", nb_path + "?watch=true&resourceVersion=abc", None, None),  # 422
        ("POST", "/apis/authorization.k8s.io/v1/subjectaccessreviews", {"spec": {
            "user": "alice@example.com", "resourceAttributes": {
                "verb": "get", "resource": "notebooks", "namespace": "team-a",
                "group": "kubeflow.org"}}}, None),
        ("POST", "/apis/authorization.k8s.io/v1/subjectaccessreviews", {"spec": {
            "user": "bob@example.com", "resourceAttributes": {
                "verb": "delete", "resource": "notebooks", "namespace": "team-a",
                "group": "kubeflow.org"}}}, None),
        ("GET", "/api/v1/namespaces/team-a/pods", None, {"X-Priority-Level": "background"}),
        ("GET", "/api/v1/namespaces/team-a/configmaps/none", None, None),
    ]
    return script


def _run_wsgi_script(pkg: str, seed: int) -> list:
    mods = wire(pkg)
    api = mods.store.APIServer()
    mods.apis.register_crds(api)
    mods.apis.install_default_cluster_roles(api)
    api.create({"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "RoleBinding",
                "metadata": {"name": "alice-edit", "namespace": "team-a"},
                "roleRef": {"apiGroup": "rbac.authorization.k8s.io", "kind": "ClusterRole",
                            "name": "kubeflow-edit"},
                "subjects": [{"kind": "User", "name": "alice@example.com"}]})
    app = mods.httpapi.RestAPI(api, inflight_limit=4)
    out = []
    for method, path, body, headers in _wsgi_script(seed):
        if pkg == "torch" and body is not None:
            body = json.loads(_to_gpu(json.dumps(body)))
        status, retry_after, ctype, payload = _wsgi(app, method, path, body, headers)
        if pkg == "jax":
            payload = _to_gpu(payload)
        out.append((method, path, status, retry_after, ctype, _MASK.sub(r'\1"*"', payload)))
    # the background level's ceiling is 2 of 4 seats: hold both
    limiter = app.limiter
    assert limiter.try_acquire("other", level=mods.overload.LEVEL_BACKGROUND)
    assert limiter.try_acquire("other", level=mods.overload.LEVEL_BACKGROUND)
    status, retry_after, ctype, payload = _wsgi(
        app, "GET", "/api/v1/namespaces/team-a/pods", headers={"X-Priority-Level": "background"})
    out.append(("shed", status, retry_after, ctype, payload))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_wsgi_script_matches_jax(seed):
    want = _run_wsgi_script("jax", seed)
    got = _run_wsgi_script("torch", seed)
    assert len(got) == len(want) >= 40
    statuses = {row[2] for row in want[:-1]}
    assert {"200", "201", "400", "404", "409", "422", "504"} <= statuses, statuses
    assert want[-1][1] == "429" and want[-1][2] == "1"
    for g, w in zip(got, want):
        assert g == w
