"""The port's admission webhooks and AdmissionReview server against the JAX
package's, on the CPU.

The same Pods, PodDefaults and Notebooks go through both packages'
admission chains (``PodDefaultWebhook``, ``NotebookWebhook``) and
AdmissionReview servers: the mutated objects, the refusals and the JSON
patches must be equal. Where JAX injects its TPU-runtime PodDefault the
port injects the GPU-runtime one; JAX's rows are carried across by the
table below, which README.md's port section states with its reasons.
"""

from __future__ import annotations

import base64
import copy
import io
import json
from pathlib import Path

import pytest

from test_torch_platform import scrub

# the TPU-runtime PodDefault's env rows → the GPU-runtime PodDefault's
# (None: no counterpart; README.md gives each reason)
RUNTIME_ROWS = {
    "JAX_PLATFORMS": None,
    "TPU_MIN_LOG_LEVEL": {"name": "TORCH_CPP_LOG_LEVEL", "value": "ERROR"},
    "TPU_STDERR_LOG_LEVEL": None,
    "TF_CPP_MIN_LOG_LEVEL": None,
    "TPU_PREMAPPED_BUFFER_SIZE": None,
    "XLA_FLAGS": None,
    "JAX_COORDINATOR_PORT": {"name": "JAX_COORDINATOR_PORT", "value": "8476"},
    "JAX_COMPILATION_CACHE_DIR": {"name": "ODH_TORCH_KERNEL_CACHE",
                                  "value": "/home/jovyan/.cache/torch_kernels"},
    "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": None,
}


def runtime_to_gpu(obj):
    """JAX's TPU-runtime output carried to the GPU-runtime one: the
    opt-in label, the PodDefault's name and description in the applied
    annotation, and the env rows by ``RUNTIME_ROWS``."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            k = {"tpu-runtime": "gpu-runtime",
                 "poddefaults.admission.kubeflow.org/poddefault-tpu-runtime":
                 "poddefaults.admission.kubeflow.org/poddefault-gpu-runtime"}.get(k, k)
            if k == "env" and isinstance(v, list):
                v = [RUNTIME_ROWS.get(e["name"], e) for e in v]
                out[k] = [e for e in v if e is not None]
            elif k == "poddefaults.admission.kubeflow.org/poddefault-gpu-runtime":
                from odh_kubeflow_tpu_torch.webhooks import gpu_runtime_poddefault

                out[k] = gpu_runtime_poddefault("x")["spec"]["desc"]
            else:
                out[k] = runtime_to_gpu(v)
        return out
    if isinstance(obj, list):
        return [runtime_to_gpu(v) for v in obj]
    return obj


def packages(port: bool):
    if port:
        from odh_kubeflow_tpu_torch import apis, webhooks
        from odh_kubeflow_tpu_torch.machinery import store
        from odh_kubeflow_tpu_torch.webhooks import certs, server

        runtime = webhooks.gpu_runtime_poddefault
    else:
        from odh_kubeflow_tpu import apis, webhooks
        from odh_kubeflow_tpu.machinery import store
        from odh_kubeflow_tpu.webhooks import certs, server

        runtime = webhooks.tpu_runtime_poddefault
    return apis, webhooks, store, server, certs, runtime


def _pod(name="p", ns="team-a", labels=None, containers=None, annotations=None):
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": ns, "labels": labels or {},
                     "annotations": annotations or {}},
        "spec": {"containers": containers or [{"name": "main", "image": "img", "env": []}]},
    }


def _poddefault(name, ns="team-a", selector=None, **spec):
    return {
        "apiVersion": "kubeflow.org/v1alpha1",
        "kind": "PodDefault",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"selector": selector or {"matchLabels": {"grp": "x"}}, **spec},
    }


# (PodDefaults, Pods created in order) — the merge semantics of JAX's
# tests/test_webhooks.py, each case through both packages
MERGE_CASES = {
    "env_volume_merge": (
        [_poddefault("defaults", env=[{"name": "FOO", "value": "bar"}],
                     volumes=[{"name": "data", "emptyDir": {}}],
                     volumeMounts=[{"name": "data", "mountPath": "/data"}])],
        [_pod(labels={"grp": "x"}), _pod(name="q")],
    ),
    "conflict_rejects": (
        [_poddefault("defaults", env=[{"name": "FOO", "value": "bar"}])],
        [_pod(labels={"grp": "x"}, containers=[
            {"name": "main", "image": "img", "env": [{"name": "FOO", "value": "other"}]}])],
    ),
    "exclusion_and_istio_skip": (
        [_poddefault("defaults", env=[{"name": "FOO", "value": "bar"}])],
        [_pod(labels={"grp": "x"},
              annotations={"poddefaults.admission.kubeflow.org/exclude": "true"}),
         _pod(name="meshed", labels={"grp": "x"}, containers=[
             {"name": "main", "image": "img"}, {"name": "istio-proxy", "image": "proxy"}])],
    ),
    "command_only_if_unset": (
        [_poddefault("defaults", command=["run.sh"], args=["--x"])],
        [_pod(labels={"grp": "x"}),
         _pod(name="has-cmd", labels={"grp": "x"},
              containers=[{"name": "main", "image": "img", "command": ["own"]}])],
    ),
    "mount_collision_and_maps": (
        [_poddefault("a", volumeMounts=[{"name": "data", "mountPath": "/data"}],
                     labels={"team": "x"}, annotations={"note": "1"},
                     tolerations=[{"key": "k", "operator": "Exists"}]),
         _poddefault("b", labels={"team": "y"})],
        [_pod(labels={"grp": "x"}),
         _pod(name="collide", labels={"grp": "z"}, containers=[
             {"name": "main", "image": "img",
              "volumeMounts": [{"name": "other", "mountPath": "/data"}]}])],
    ),
}


def _admit_all(port: bool, poddefaults, pods):
    _, webhooks, store, *_ = packages(port)
    api = store.APIServer()
    packages(port)[0].register_crds(api)
    webhooks.PodDefaultWebhook(api).register()
    for pd in poddefaults:
        api.create(copy.deepcopy(pd))
    out = []
    for pod in pods:
        try:
            out.append(scrub(api.create(copy.deepcopy(pod))))
        except store.APIError as e:
            out.append((type(e).__name__, e.code, str(e)))
    return out


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_poddefault_merge_matches_jax(case):
    poddefaults, pods = MERGE_CASES[case]
    want, got = _admit_all(False, poddefaults, pods), _admit_all(True, poddefaults, pods)
    assert got == want
    if case == "conflict_rejects":
        assert got[0][:2] == ("MergeConflict", 403)
    if case == "env_volume_merge":
        c0 = got[0]["spec"]["containers"][0]
        assert {"name": "FOO", "value": "bar"} in c0["env"]
        assert got[1]["spec"]["containers"][0]["env"] == []


def test_gpu_runtime_poddefault_is_the_tpu_one_row_by_row():
    """The pod the GPU-runtime PodDefault admits equals the pod JAX's
    TPU-runtime PodDefault admits with its rows carried across."""
    got = _admit_all(True, [packages(True)[5]("team-a")],
                     [_pod(labels={"gpu-runtime": "enabled"})])
    want = _admit_all(False, [packages(False)[5]("team-a")],
                      [_pod(labels={"tpu-runtime": "enabled"})])
    assert got == runtime_to_gpu(want)
    c0 = got[0]["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in c0["env"]}
    assert env == {"TORCH_CPP_LOG_LEVEL": "ERROR", "JAX_COORDINATOR_PORT": "8476",
                   "ODH_TORCH_KERNEL_CACHE": "/home/jovyan/.cache/torch_kernels"}
    assert {"name": "dshm", "mountPath": "/dev/shm"} in c0["volumeMounts"]
    # the kernel build directory reads the variable the PodDefault sets
    from odh_kubeflow_tpu_torch.ops import _build

    assert _build.KERNEL_CACHE_ENV == "ODH_TORCH_KERNEL_CACHE"
    # every TPU row is accounted for, and README.md's table names it
    jax_rows = [e["name"] for e in packages(False)[5]("t")["spec"]["env"]]
    assert sorted(jax_rows) == sorted(RUNTIME_ROWS)
    readme = (Path(__file__).resolve().parent.parent / "README.md").read_text()
    assert all(f"| `{name}" in readme for name in RUNTIME_ROWS)


def _notebook(name="nb1", ns="team-a", annotations=None):
    return {
        "apiVersion": "kubeflow.org/v1beta1",
        "kind": "Notebook",
        "metadata": {"name": name, "namespace": ns, "annotations": annotations or {}},
        "spec": {"template": {"spec": {"containers": [{"name": name, "image": "img"}]}}},
    }


PROXY = {
    "apiVersion": "v1", "kind": "ConfigMap",
    "metadata": {"name": "cluster-proxy-config", "namespace": "kube-system"},
    "data": {"httpProxy": "http://proxy:3128", "httpsProxy": "http://proxy:3128",
             "noProxy": ".cluster.local,.svc", "trustedCABundle": "yes"},
}


def _notebook_admission(port: bool, proxy: bool):
    apis, webhooks, store, *_ = packages(port)
    api = store.APIServer()
    apis.register_crds(api)
    if proxy:
        api.create(copy.deepcopy(PROXY))
    webhooks.NotebookWebhook(api).register()
    auth = api.create(_notebook(annotations={
        "notebooks.opendatahub.io/inject-oauth": "true",
        "notebooks.opendatahub.io/oauth-logout-url": "https://example.com/logout"}))
    plain = api.create(_notebook(name="plain"))
    updated = api.patch("Notebook", "plain", {"metadata": {"labels": {"x": "1"}}}, "team-a")
    return scrub([auth, plain, updated])


@pytest.mark.parametrize("proxy", [False, True], ids=["no-proxy", "cluster-proxy"])
def test_notebook_webhook_matches_jax(proxy):
    """The auth-proxy sidecar and the reconciliation lock on create, and
    the cluster-proxy env and trusted-CA mount on create and update."""
    want, got = _notebook_admission(False, proxy), _notebook_admission(True, proxy)
    assert got == want
    auth, plain, _ = got
    assert auth["metadata"]["annotations"]["kubeflow-resource-stopped"] == (
        "odh-notebook-controller-lock")
    assert [c["name"] for c in auth["spec"]["template"]["spec"]["containers"]] == [
        "nb1", "auth-proxy"]
    assert "kubeflow-resource-stopped" not in plain["metadata"]["annotations"]
    env = {e["name"]: e["value"] for e in plain["spec"]["template"]["spec"]["containers"][0]
           .get("env", [])}
    assert (env.get("NO_PROXY") == ".cluster.local,.svc") is proxy


# -- the AdmissionReview wire protocol (JAX's tests/test_admission_server.py)


def _apply_patch(obj, ops):
    obj = copy.deepcopy(obj)
    for op in ops:
        parts = [p.replace("~1", "/").replace("~0", "~") for p in op["path"].split("/")[1:]]
        target = obj
        for p in parts[:-1]:
            target = target[p]
        if op["op"] == "remove":
            del target[parts[-1]]
        else:
            target[parts[-1]] = op["value"]
    return obj


@pytest.mark.parametrize("old,new", [
    ({"a": 1}, {"a": 2}),
    ({"a": {"b": [1, 2]}}, {"a": {"b": [1, 2, 3]}, "c": "x"}),
    ({"a": 1, "b": 2}, {"b": 2}),
    ({"x/y": {"m~n": 1}}, {"x/y": {"m~n": 2}}),
    ({}, {"spec": {"containers": [{"name": "c"}]}}),
])
def test_json_patch_diff_matches_jax(old, new):
    from odh_kubeflow_tpu.webhooks.server import json_patch_diff as jax_diff
    from odh_kubeflow_tpu_torch.webhooks.server import json_patch_diff

    ops = json_patch_diff(old, new)
    assert ops == jax_diff(old, new)
    assert _apply_patch(old, ops) == new


def _review(app, path, obj, operation="CREATE"):
    body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                       "request": {"uid": "u1", "operation": operation,
                                   "object": obj}}).encode()
    captured = {}
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path,
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body),
               "QUERY_STRING": ""}
    out = b"".join(app(environ, lambda status, headers: captured.update(status=status)))
    assert captured["status"].startswith("200")
    return json.loads(out.decode())["response"]


def _runtime_review(port: bool, labelled: bool):
    apis, webhooks, store, server, _, runtime = packages(port)
    api = store.APIServer()
    apis.register_crds(api)
    api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "t"}})
    api.create(runtime("t"))
    webhook = webhooks.PodDefaultWebhook(api)
    srv = server.AdmissionServer().handle("/apply-poddefault", webhook.mutate)
    labels = {("gpu-runtime" if port else "tpu-runtime"): "enabled"} if labelled else {}
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "p1", "namespace": "t", "labels": labels},
           "spec": {"containers": [{"name": "main", "image": "x"}]}}
    resp = _review(srv.app, "/apply-poddefault", pod)
    patched = None
    if "patch" in resp:
        ops = json.loads(base64.b64decode(resp["patch"]).decode())
        patched = _apply_patch(pod, ops)
        # byte-identical with the in-process admission result
        expected = webhook.mutate(store.AdmissionRequest("CREATE", json.loads(json.dumps(pod)),
                                                         None, False))
        assert patched == expected
    return {k: v for k, v in resp.items() if k != "patch"}, patched


@pytest.mark.parametrize("labelled", [True, False], ids=["runtime-pod", "non-matching-pod"])
def test_admission_review_matches_jax(labelled):
    want, got = _runtime_review(False, labelled), _runtime_review(True, labelled)
    assert list(got) == runtime_to_gpu(list(want))
    resp, patched = got
    assert resp["allowed"] is True
    assert (resp.get("patchType") == "JSONPatch") is labelled
    if labelled:
        names = {e["name"] for e in patched["spec"]["containers"][0]["env"]}
        assert "ODH_TORCH_KERNEL_CACHE" in names
    else:
        assert patched is None


def _tls_server(tmp_path, api_runtime=True):
    import odh_kubeflow_tpu_torch.apis as apis
    from odh_kubeflow_tpu_torch.machinery.store import APIServer
    from odh_kubeflow_tpu_torch.webhooks import PodDefaultWebhook, gpu_runtime_poddefault
    from odh_kubeflow_tpu_torch.webhooks.certs import generate_webhook_certs
    from odh_kubeflow_tpu_torch.webhooks.server import AdmissionServer, make_ssl_context

    api = APIServer()
    apis.register_crds(api)
    api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "t"}})
    if api_runtime:
        api.create(gpu_runtime_poddefault("t"))
    srv = AdmissionServer().handle("/apply-poddefault", PodDefaultWebhook(api).mutate)
    cert_file, key_file, ca_file = generate_webhook_certs(dns_names=["localhost"]).write(
        str(tmp_path))
    httpd = srv.app.serve("127.0.0.1", 0, ssl_context=make_ssl_context(cert_file, key_file))
    return httpd, ca_file


def test_admission_review_over_tls(tmp_path):
    """HTTPS serving with a generated cert the client verifies against
    the bootstrap CA; an unverified client fails the handshake."""
    import ssl
    import urllib.request

    httpd, ca_file = _tls_server(tmp_path)
    port = httpd.server_address[1]
    try:
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "p1", "namespace": "t",
                            "labels": {"gpu-runtime": "enabled"}},
               "spec": {"containers": [{"name": "main", "image": "x"}]}}
        body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                           "request": {"uid": "u2", "operation": "CREATE",
                                       "object": pod}}).encode()
        req = urllib.request.Request(f"https://localhost:{port}/apply-poddefault", data=body,
                                     headers={"Content-Type": "application/json"})
        ctx = ssl.create_default_context(cafile=ca_file)
        with urllib.request.urlopen(req, context=ctx, timeout=10) as r:
            resp = json.loads(r.read().decode())["response"]
        assert resp["allowed"] is True and resp["uid"] == "u2"
        patched = _apply_patch(pod, json.loads(base64.b64decode(resp["patch"]).decode()))
        assert "ODH_TORCH_KERNEL_CACHE" in {
            e["name"] for e in patched["spec"]["containers"][0]["env"]}
        with pytest.raises(Exception):
            urllib.request.urlopen(f"https://localhost:{port}/healthz", timeout=10)
    finally:
        httpd.shutdown()


def test_silent_client_does_not_block_tls_serving(tmp_path):
    """A connection that never sends a ClientHello must not park the
    accept loop: the handshake runs in the connection's own thread."""
    import socket
    import ssl
    import urllib.request

    httpd, ca_file = _tls_server(tmp_path, api_runtime=False)
    port = httpd.server_address[1]
    try:
        mute = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            ctx = ssl.create_default_context(cafile=ca_file)
            with urllib.request.urlopen(f"https://localhost:{port}/healthz", context=ctx,
                                        timeout=10) as r:
                assert r.read() == b"ok"
        finally:
            mute.close()
    finally:
        httpd.shutdown()


def _bootstrap(port: bool):
    apis, _, store, _, certs, _ = packages(port)
    api = store.APIServer()
    apis.register_crds(api)
    api.create({"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": "kubeflow"}})
    api.create({"apiVersion": "admissionregistration.k8s.io/v1",
                "kind": "MutatingWebhookConfiguration",
                "metadata": {"name": certs.WEBHOOK_CONFIG_NAME},
                "webhooks": [{"name": "poddefaults.kubeflow.org", "clientConfig": {}},
                             {"name": "notebooks.kubeflow.org", "clientConfig": {}}]})
    b1, b2 = certs.bootstrap(api), certs.bootstrap(api)
    cfg = api.get("MutatingWebhookConfiguration", certs.WEBHOOK_CONFIG_NAME, None)
    secret = api.get("Secret", certs.SECRET_NAME, "kubeflow")
    return {
        "reused": b1.cert_pem == b2.cert_pem,
        "ca_bundles": [h["clientConfig"]["caBundle"] == b1.ca_bundle_b64
                       for h in cfg["webhooks"]],
        "secret_keys": sorted(secret["data"]), "secret_type": secret["type"],
        "names": (certs.SECRET_NAME, certs.WEBHOOK_CONFIG_NAME),
    }


def test_cert_bootstrap_matches_jax():
    """First run generates the Secret, the second reuses it, and every
    webhook of the configuration carries the CA that signed it."""
    got = _bootstrap(True)
    assert got == _bootstrap(False)
    assert got["reused"] and all(got["ca_bundles"])
