"""The port's cloud-IAM clients (``machinery/cloudiam.py``) and the profile
controller's ``plugins_from_env``, held to the JAX package's.

Every case of ``tests/test_cloudiam.py`` runs on both packages (``m``,
``test_torch_overload.wire``'s module table)
against the same fake HTTP layer; the policy documents, the calls made
and the signed headers must be equal.
"""

import datetime
import json
import urllib.parse

import pytest

from test_torch_overload import wire

MEMBER = "serviceAccount:team-a.svc.id.goog[team-a/default-editor]"
OIDC_ARN = "arn:aws:iam::123456789012:oidc-provider/oidc.eks.us-west-2.amazonaws.com/id/ABC"
ISSUER = "oidc.eks.us-west-2.amazonaws.com/id/ABC"
TRUST = {"Version": "2012-10-17",
         "Statement": [{"Effect": "Allow", "Principal": {"Service": "ec2.amazonaws.com"},
                        "Action": "sts:AssumeRole"}]}


def both(scenario):
    return scenario(wire("jax")), scenario(wire("torch"))


def modify_policy_add_remove_idempotent(m):
    iam = m.cloudiam
    policy = {"etag": "abc", "bindings": [{"role": "roles/viewer", "members": ["user:x"]}]}
    p1 = iam.modify_policy_bindings(policy, iam.WORKLOAD_IDENTITY_ROLE, MEMBER, add=True)
    assert {"role": iam.WORKLOAD_IDENTITY_ROLE, "members": [MEMBER]} in p1["bindings"]
    p2 = iam.modify_policy_bindings(p1, iam.WORKLOAD_IDENTITY_ROLE, MEMBER, add=True)
    assert p2 == p1
    p3 = iam.modify_policy_bindings(p2, iam.WORKLOAD_IDENTITY_ROLE, MEMBER, add=False)
    assert all(b["role"] != iam.WORKLOAD_IDENTITY_ROLE for b in p3["bindings"])
    assert iam.modify_policy_bindings(p3, iam.WORKLOAD_IDENTITY_ROLE, MEMBER, add=False) == p3
    return p1, p3


def gcp_client_read_modify_write_and_etag_retry(m):
    calls = []
    state = {"policy": {"etag": "v1", "bindings": []}, "conflicts": 1}

    def http_fn(method, url, headers, body):
        calls.append((method, url, body.decode() if body else None,
                      headers.get("Authorization")))
        if url.endswith(":getIamPolicy"):
            return 200, json.dumps(state["policy"]).encode()
        if url.endswith(":setIamPolicy"):
            if state["conflicts"] > 0:
                state["conflicts"] -= 1
                return 409, b"etag mismatch"
            state["policy"] = json.loads(body.decode())["policy"]
            return 200, json.dumps(state["policy"]).encode()
        return 404, b""

    client = m.cloudiam.GcpIamClient(token_fn=lambda: "tok", http_fn=http_fn)
    client._sleep = lambda s: None
    client("ml-sa@proj.iam.gserviceaccount.com", MEMBER, "add")
    added = json.loads(json.dumps(state["policy"]))
    urls = [u for _, u, _, _ in calls]
    assert sum(u.endswith(":getIamPolicy") for u in urls) == 2
    assert "projects/-/serviceAccounts/ml-sa@proj.iam.gserviceaccount.com" in urls[0]
    client("ml-sa@proj.iam.gserviceaccount.com", MEMBER, "remove")
    assert state["policy"]["bindings"] == []
    return added, calls


def gcp_client_surfaces_api_errors(m):
    client = m.cloudiam.GcpIamClient(http_fn=lambda *a: (403, b"denied"))
    with pytest.raises(m.cloudiam.GcpIamError) as ei:
        client("sa@p.iam.gserviceaccount.com", MEMBER, "add")
    return str(ei.value)


def irsa_statement_add_remove_preserves_others(m):
    added = m.cloudiam.ensure_irsa_statement(TRUST, OIDC_ARN, ISSUER, "team-a/default-editor", True)
    assert len(added["Statement"]) == 2
    assert added["Statement"][1]["Condition"]["StringEquals"][f"{ISSUER}:sub"] == (
        "system:serviceaccount:team-a/default-editor")
    again = m.cloudiam.ensure_irsa_statement(added, OIDC_ARN, ISSUER, "team-a/default-editor", True)
    assert len(again["Statement"]) == 2
    removed = m.cloudiam.ensure_irsa_statement(again, OIDC_ARN, ISSUER, "team-a/default-editor",
                                          False)
    assert removed["Statement"] == TRUST["Statement"]
    return added, removed


def sigv4_known_vector(m):
    """AWS's published SigV4 example request (GET iam.amazonaws.com
    Action=ListUsers, 2015-08-30, the example keys): scope, signed
    headers and date follow the spec, and the signature equals JAX's."""
    headers = m.cloudiam.sigv4_headers(
        "GET", "https://iam.amazonaws.com/?Action=ListUsers&Version=2010-05-08", b"",
        access_key="AKIDEXAMPLE", secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
        region="us-east-1", service="iam",
        now=datetime.datetime(2015, 8, 30, 12, 36, 0, tzinfo=datetime.timezone.utc))
    assert "Credential=AKIDEXAMPLE/20150830/us-east-1/iam/aws4_request" in headers["Authorization"]
    assert "SignedHeaders=host;x-amz-date" in headers["Authorization"]
    assert headers["x-amz-date"] == "20150830T123600Z"
    return headers


def aws_client_get_munge_update(m):
    calls = []

    def http_fn(method, url, headers, body):
        params = dict(urllib.parse.parse_qsl(body.decode()))
        calls.append(params)
        assert "Authorization" in headers
        if params["Action"] == "GetRole":
            doc = urllib.parse.quote(json.dumps(TRUST))
            return 200, (f"<GetRoleResponse><Role><AssumeRolePolicyDocument>{doc}"
                         "</AssumeRolePolicyDocument></Role></GetRoleResponse>").encode()
        if params["Action"] == "UpdateAssumeRolePolicy":
            return 200, b"<ok/>"
        return 400, b"bad"

    client = m.cloudiam.AwsIamClient(oidc_provider_arn=OIDC_ARN, issuer_host=ISSUER,
                                access_key="AKID", secret_key="secret", http_fn=http_fn)
    client("arn:aws:iam::123456789012:role/ml-role", "team-a/default-editor", "add")
    updated = json.loads(calls[-1]["PolicyDocument"])
    assert len(updated["Statement"]) == 2
    assert updated["Statement"][1]["Principal"]["Federated"] == OIDC_ARN
    assert calls[0]["RoleName"] == "ml-role"
    return [sorted(c) for c in calls], updated


def profile_plugin_drives_gcp_client_end_to_end(m):
    """A Profile with a WorkloadIdentity plugin: the KSA is annotated and
    the IAM binding made through the fake-HTTP client; deleting the
    Profile revokes it through the same client."""
    state = {"policy": {"bindings": []}}

    def http_fn(method, url, headers, body):
        if url.endswith(":getIamPolicy"):
            return 200, json.dumps(state["policy"]).encode()
        state["policy"] = json.loads(body.decode())["policy"]
        return 200, b"{}"

    api = m.store.APIServer()
    m.apis.register_crds(api)
    mgr = m.runtime.Manager(api)
    m.profile.ProfileController(api, plugins={
        "WorkloadIdentity": m.profile.GcpWorkloadIdentityPlugin(
            iam_client=m.cloudiam.GcpIamClient(http_fn=http_fn))}).register(mgr)
    api.create({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                "metadata": {"name": "team-a"},
                "spec": {"owner": {"kind": "User", "name": "a@example.com"},
                         "plugins": [{"kind": "WorkloadIdentity",
                                      "spec": {"gcpServiceAccount":
                                               "ml@proj.iam.gserviceaccount.com"}}]}})
    mgr.drain()
    sa = api.get("ServiceAccount", "default-editor", "team-a")
    annotation = sa["metadata"]["annotations"]["iam.gke.io/gcp-service-account"]
    assert annotation == "ml@proj.iam.gserviceaccount.com"
    granted = json.loads(json.dumps(state["policy"]))
    assert MEMBER in granted["bindings"][0]["members"]
    api.delete("Profile", "team-a", None)
    mgr.drain()
    assert state["policy"]["bindings"] == []
    return annotation, granted


@pytest.mark.parametrize("scenario", [
    modify_policy_add_remove_idempotent,
    gcp_client_read_modify_write_and_etag_retry,
    gcp_client_surfaces_api_errors,
    irsa_statement_add_remove_preserves_others,
    sigv4_known_vector,
    aws_client_get_munge_update,
    profile_plugin_drives_gcp_client_end_to_end,
], ids=lambda f: f.__name__)
def test_cloudiam_scenario_equal_on_both(scenario):
    jax_rec, torch_rec = both(scenario)
    assert torch_rec == jax_rec


def test_plugins_from_env_wiring(monkeypatch):
    """The split-process profile controller builds real IAM clients only
    where the deployment configures them, no-op clients otherwise, on
    both packages alike."""
    records = []
    for name in ("jax", "torch"):
        m = wire(name)
        for var in ("GCP_IAM_ENABLE", "AWS_OIDC_PROVIDER_ARN", "AWS_OIDC_ISSUER_HOST",
                    "AWS_REGION"):
            monkeypatch.delenv(var, raising=False)
        plugins = m.profile.plugins_from_env()
        assert set(plugins) == {"WorkloadIdentity", "AwsIamForServiceAccount"}
        assert not isinstance(plugins["WorkloadIdentity"].iam_client, m.cloudiam.GcpIamClient)
        monkeypatch.setenv("GCP_IAM_ENABLE", "true")
        monkeypatch.setenv("AWS_OIDC_PROVIDER_ARN", OIDC_ARN)
        monkeypatch.setenv("AWS_OIDC_ISSUER_HOST", ISSUER)
        monkeypatch.setenv("AWS_REGION", "us-west-2")
        plugins = m.profile.plugins_from_env()
        gcp = plugins["WorkloadIdentity"].iam_client
        aws = plugins["AwsIamForServiceAccount"].iam_client
        assert isinstance(gcp, m.cloudiam.GcpIamClient) and isinstance(aws, m.cloudiam.AwsIamClient)
        records.append((aws.oidc_provider_arn, aws.issuer_host, aws.region, gcp.max_retries))
    assert records[0] == records[1]
    assert records[1][:3] == (OIDC_ARN, ISSUER, "us-west-2")
