"""Cloud IAM clients for the profile plugins (the port's copy of the JAX
package's ``machinery/cloudiam.py``).

The reference's plugins perform *real* cloud mutations: the GCP plugin
adds a ``roles/iam.workloadIdentityUser`` binding via the IAM API
(plugin_workload_identity.go:32-52) and the AWS plugin edits the role's
trust policy via the IAM SDK (plugin_iam.go:22-80). Without a client
the plugins stop at KSA annotations; these clients do the mutations:

- :class:`GcpIamClient` — getIamPolicy → modify → setIamPolicy with
  etag-based optimistic concurrency (the documented read-modify-write
  recipe) against ``iam.googleapis.com``.
- :class:`AwsIamClient` — GetRole → trust-policy munge →
  UpdateAssumeRolePolicy against the IAM Query API, request-signed
  with stdlib SigV4 (no boto in this image).

Both take an injectable ``http_fn(method, url, headers, body) ->
(status, body)`` so tests (and the in-cluster default of a cluster
without egress) never talk to real clouds; the policy/trust-document
munging is pure and unit-tested the way the reference tests
plugin_iam's statement surgery.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Optional

from odh_kubeflow_tpu_torch.machinery import backoff

Obj = dict[str, Any]

HttpFn = Callable[[str, str, dict, Optional[bytes]], tuple[int, bytes]]

WORKLOAD_IDENTITY_ROLE = "roles/iam.workloadIdentityUser"


def _default_http(method: str, url: str, headers: dict, body: Optional[bytes]):
    req = urllib.request.Request(url, data=body, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.getcode(), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------------------------------------------------------------------
# GCP: workload-identity binding on the GCP service account


class GcpIamError(RuntimeError):
    pass


def modify_policy_bindings(policy: Obj, role: str, member: str, add: bool) -> Obj:
    """Pure read-modify step of the documented read-modify-write cycle.
    Idempotent both ways; drops an emptied binding on removal."""
    bindings = [dict(b) for b in policy.get("bindings") or []]
    target = None
    for b in bindings:
        if b.get("role") == role:
            target = b
            break
    if add:
        if target is None:
            target = {"role": role, "members": []}
            bindings.append(target)
        if member not in (target.get("members") or []):
            target.setdefault("members", []).append(member)
    elif target is not None:
        target["members"] = [m for m in target.get("members") or [] if m != member]
        if not target["members"]:
            bindings.remove(target)
    out = dict(policy)
    out["bindings"] = bindings
    return out


class GcpIamClient:
    """Workload-identity binding via the IAM API's get/setIamPolicy
    pair, with etag conflict retry (status 409, per the API contract)
    paced by the shared backoff helper (``machinery.backoff``) —
    jittered delays, capped attempts — instead of a private
    fixed-count loop."""

    def __init__(
        self,
        token_fn: Optional[Callable[[], str]] = None,
        http_fn: Optional[HttpFn] = None,
        endpoint: str = "https://iam.googleapis.com/v1",
        max_retries: int = 3,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ):
        self.token_fn = token_fn or (lambda: "")
        self.http = http_fn or _default_http
        self.endpoint = endpoint.rstrip("/")
        self.max_retries = max_retries
        self._sleep = sleep_fn

    def _call(self, method: str, path: str, body: Optional[Obj] = None) -> Obj:
        headers = {"Content-Type": "application/json"}
        token = self.token_fn()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        status, raw = self.http(
            method,
            f"{self.endpoint}{path}",
            headers,
            # outbound cloud-API request body, not a serving path
            json.dumps(body).encode() if body is not None else None,  # dumps-ok: outbound
        )
        if status == 409:
            raise _EtagConflict()
        if status >= 400:
            raise GcpIamError(f"{method} {path}: HTTP {status}: {raw[:300]!r}")
        return json.loads(raw.decode() or "{}")

    def _modify(self, gcp_sa: str, member: str, add: bool) -> None:
        resource = f"/projects/-/serviceAccounts/{gcp_sa}"

        def read_modify_write() -> None:
            policy = self._call("POST", f"{resource}:getIamPolicy")
            updated = modify_policy_bindings(
                policy, WORKLOAD_IDENTITY_ROLE, member, add
            )
            self._call("POST", f"{resource}:setIamPolicy", {"policy": updated})

        try:
            backoff.retry(  # budget-ok: third-party IAM etag races, capped attempts against Google's API — not platform-fleet amplification
                read_modify_write,
                retryable=(_EtagConflict,),
                attempts=self.max_retries,
                base=0.02,
                cap=0.5,
                sleep_fn=self._sleep,
            )
        except _EtagConflict:
            raise GcpIamError(
                f"setIamPolicy on {gcp_sa}: etag conflict persisted "
                f"after {self.max_retries} attempts"
            ) from None

    # plugin-facing callable contract: (gcp_sa, member, action)
    def __call__(self, gcp_sa: str, member: str, action: str) -> None:
        self._modify(gcp_sa, member, add=(action == "add"))


class _EtagConflict(Exception):
    pass


# ---------------------------------------------------------------------------
# AWS: IRSA trust-policy surgery (plugin_iam.go:22-80 equivalent)


def ensure_irsa_statement(
    trust_policy: Obj, oidc_provider_arn: str, issuer_host: str, ksa: str, add: bool
) -> Obj:
    """Add/remove the federated statement letting ``system:serviceaccount:
    <ns>/<sa>`` (``ksa``) assume the role via the cluster's OIDC
    provider. Pure and idempotent — the reference's statement-munging
    functions (plugin_iam.go) are tested exactly this way."""
    doc = dict(trust_policy or {})
    doc.setdefault("Version", "2012-10-17")
    statements = [dict(s) for s in doc.get("Statement") or []]

    def is_ours(stmt: Obj) -> bool:
        if stmt.get("Action") != "sts:AssumeRoleWithWebIdentity":
            return False
        fed = (stmt.get("Principal") or {}).get("Federated")
        cond = (stmt.get("Condition") or {}).get("StringEquals") or {}
        return fed == oidc_provider_arn and cond.get(f"{issuer_host}:sub") == (
            f"system:serviceaccount:{ksa}"
        )

    statements = [s for s in statements if not is_ours(s)]
    if add:
        statements.append(
            {
                "Effect": "Allow",
                "Principal": {"Federated": oidc_provider_arn},
                "Action": "sts:AssumeRoleWithWebIdentity",
                "Condition": {
                    "StringEquals": {
                        f"{issuer_host}:sub": f"system:serviceaccount:{ksa}"
                    }
                },
            }
        )
    doc["Statement"] = statements
    return doc


def sigv4_headers(
    method: str,
    url: str,
    body: bytes,
    *,
    access_key: str,
    secret_key: str,
    region: str,
    service: str,
    now: Optional[datetime.datetime] = None,
    session_token: str = "",
) -> dict:
    """AWS Signature Version 4 with stdlib hmac (no boto in the image).
    Follows the documented canonical-request recipe; unit-tested
    against AWS's published test vector."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlsplit(url)
    host = parsed.netloc
    canonical_uri = urllib.parse.quote(parsed.path or "/")
    query_pairs = sorted(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
    canonical_qs = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
        for k, v in query_pairs
    )
    payload_hash = hashlib.sha256(body).hexdigest()
    headers = {"host": host, "x-amz-date": amz_date}
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [method, canonical_uri, canonical_qs, canonical_headers, signed_headers,
         payload_hash]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_date = _hmac(f"AWS4{secret_key}".encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(
        k_signing, string_to_sign.encode(), hashlib.sha256
    ).hexdigest()

    out = dict(headers)
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


class AwsIamError(RuntimeError):
    pass


class AwsIamClient:
    """GetRole → munge trust policy → UpdateAssumeRolePolicy against
    the IAM Query API (the SDK-free equivalent of plugin_iam.go)."""

    def __init__(
        self,
        *,
        oidc_provider_arn: str,
        issuer_host: str,
        access_key: str = "",
        secret_key: str = "",
        session_token: str = "",
        region: str = "us-east-1",
        http_fn: Optional[HttpFn] = None,
        endpoint: str = "https://iam.amazonaws.com/",
    ):
        self.oidc_provider_arn = oidc_provider_arn
        self.issuer_host = issuer_host
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.region = region
        self.http = http_fn or _default_http
        self.endpoint = endpoint

    def _query(self, params: dict) -> bytes:
        body = urllib.parse.urlencode(
            {**params, "Version": "2010-05-08"}
        ).encode()
        headers = sigv4_headers(
            "POST",
            self.endpoint,
            body,
            access_key=self.access_key,
            secret_key=self.secret_key,
            region=self.region,
            service="iam",
            session_token=self.session_token,
        )
        headers["Content-Type"] = "application/x-www-form-urlencoded"
        status, raw = self.http("POST", self.endpoint, headers, body)
        if status >= 400:
            raise AwsIamError(f"{params.get('Action')}: HTTP {status}: {raw[:300]!r}")
        return raw

    @staticmethod
    def _role_name(arn: str) -> str:
        return arn.rsplit("/", 1)[-1]

    def get_trust_policy(self, role_arn: str) -> Obj:
        raw = self._query(
            {"Action": "GetRole", "RoleName": self._role_name(role_arn)}
        ).decode()
        # AssumeRolePolicyDocument arrives URL-encoded inside the XML
        import re

        m = re.search(
            r"<AssumeRolePolicyDocument>(.*?)</AssumeRolePolicyDocument>",
            raw,
            re.S,
        )
        if not m:
            raise AwsIamError(f"GetRole({role_arn}): no trust policy in response")
        return json.loads(urllib.parse.unquote(m.group(1)))

    def _modify(self, role_arn: str, ksa: str, add: bool) -> None:
        doc = ensure_irsa_statement(
            self.get_trust_policy(role_arn),
            self.oidc_provider_arn,
            self.issuer_host,
            ksa,
            add,
        )
        self._query(
            {
                "Action": "UpdateAssumeRolePolicy",
                "RoleName": self._role_name(role_arn),
                # outbound cloud-API payload, not a serving path
                "PolicyDocument": json.dumps(doc),  # dumps-ok: outbound
            }
        )

    # plugin-facing callable contract: (role_arn, "<ns>/<sa>", action)
    def __call__(self, role_arn: str, ksa: str, action: str) -> None:
        self._modify(role_arn, ksa, add=(action == "add"))
