"""S3 request authentication for RGW-lite.

Rebuild of the reference's S3 auth engine (ref: src/rgw/rgw_auth_s3.cc
— AWSv4 canonical request assembly, the HMAC key-derivation chain in
get_v4_signing_key, clock-skew enforcement in RGW_AUTH_GRACE;
src/rgw/rgw_rest_s3.cc dispatches verified requests to the ops). Shape
kept, trimmed to this framework's surface:

* CANONICAL REQUEST. Every call signs (op, bucket, key, client nonce,
  sorted-params JSON, SHA-256 of the payload). The server recomputes
  the canonical string from the parameters it will actually execute —
  tampering with ANY of them (op swap, key swap, payload swap, range
  change) breaks the signature.
* KEY DERIVATION (SigV4's chain, re-labeled): the signing key is
  HMAC-chained from the user's secret through date / region / service
  / terminator, so a leaked per-request signing key expires with its
  date and never reveals the long-term secret.
* CLOCK SKEW. Requests carry an amz-date; outside the +/-900 s window
  the server refuses (RequestTimeTooSkewed) BEFORE any signature
  math — same order as the reference.
* REPLAY. The reference leans on TLS + the skew window; this wire has
  sessions of its own (msgr secure mode), but the gateway ALSO keeps
  a seen-signature cache for the skew window so a captured request
  cannot be re-executed inside it (the client nonce makes legitimate
  identical calls sign differently).

Credentials are (access_key, secret_key) pairs from UserStore — the
RGWUserCtl role, kept in-memory because user metadata storage is a
context-tier concern (SURVEY L8)."""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import time

from .gateway import Gateway, GatewayError, NoSuchBucket

ALGO = "CEPH-TPU-HMAC-SHA256"
REGION = "tpu"
SERVICE = "s3"
TERM = "ceph4_request"
SKEW_MAX = 900.0            # seconds, the reference's auth grace


class AuthError(GatewayError):
    pass


class AccessDenied(AuthError):
    pass


class SignatureDoesNotMatch(AuthError):
    pass


class RequestTimeTooSkewed(AuthError):
    pass


def _hex_sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def canonical_request(op: str, bucket: str, key: str, nonce: str,
                      params: dict, payload: bytes) -> str:
    """Everything the server will act on, in one deterministic
    string (the AWSv4 canonical request role). Fields are LENGTH-
    PREFIXED, not merely joined: client-controlled fields containing
    the join character must not let two different (bucket, key,
    nonce) bindings collapse to one canonical string (SigV4 gets the
    same property from URI-encoding)."""
    fields = [op, bucket, key, nonce,
              json.dumps(params, sort_keys=True),
              _hex_sha256(payload)]
    return "".join(f"{len(f)}:{f}\n" for f in fields)


def signing_key(secret_key: str, date: str) -> bytes:
    """SigV4's derivation chain: secret -> date -> region -> service
    -> terminator (ref: rgw_auth_s3.cc get_v4_signing_key)."""
    k = _hmac(("CEPH4" + secret_key).encode(), date)
    k = _hmac(k, REGION)
    k = _hmac(k, SERVICE)
    return _hmac(k, TERM)


def sign(secret_key: str, amz_date: str, op: str, bucket: str,
         key: str, nonce: str, params: dict, payload: bytes) -> str:
    scope = f"{amz_date[:8]}/{REGION}/{SERVICE}/{TERM}"
    string_to_sign = "\n".join([
        ALGO, amz_date, scope,
        _hex_sha256(canonical_request(op, bucket, key, nonce, params,
                                      payload).encode()),
    ])
    return hmac.new(signing_key(secret_key, amz_date[:8]),
                    string_to_sign.encode(), hashlib.sha256).hexdigest()


def amz_date(t: float) -> str:
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(t))


def _parse_amz_date(s: str) -> float:
    import calendar
    try:
        return calendar.timegm(time.strptime(s, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise AccessDenied(f"malformed amz-date {s!r}") from None


class UserStore:
    """access_key -> (uid, secret_key) — the RGWUserCtl role."""

    def __init__(self):
        self._by_access: dict[str, tuple[str, str]] = {}

    def create_user(self, uid: str) -> tuple[str, str]:
        access = "AK" + os.urandom(8).hex().upper()
        secret = os.urandom(20).hex()
        self._by_access[access] = (uid, secret)
        return access, secret

    def lookup(self, access_key: str) -> tuple[str, str]:
        """(uid, secret_key) — uid drives authorization, secret the
        signature check."""
        ent = self._by_access.get(access_key)
        if ent is None:
            raise AccessDenied(f"InvalidAccessKeyId: {access_key}")
        return ent


class AuthedGateway:
    """Signature-checking front of a Gateway: verify, then dispatch.
    The op table is the REST dispatch role (rgw_rest_s3.cc) without
    the HTTP parsing."""

    _OPS = ("create_bucket", "delete_bucket", "list_buckets",
            "put_object", "get_object", "head_object", "delete_object",
            "list_objects", "initiate_multipart", "upload_part",
            "complete_multipart", "abort_multipart",
            "put_bucket_versioning", "get_bucket_versioning",
            "list_object_versions", "copy_object")

    def __init__(self, gateway: Gateway, users: UserStore,
                 clock=time.time):
        import threading
        self._gw = gateway
        self._users = users
        self._clock = clock
        self._seen: dict[str, float] = {}    # signature -> expiry
        self._seen_lock = threading.Lock()
        self._last_prune = 0.0
        # bucket -> owning uid, for buckets created THROUGH this
        # authed front (the rgw_bucket owner field's role). A bucket
        # owned by another uid — or with NO recorded owner (created
        # on the raw Gateway, outside this auth layer) — is denied
        # outright: unknown ownership must not read as world-access.
        self._owner: dict[str, str] = {}

    def adopt_bucket(self, bucket: str, uid: str) -> None:
        """Admin-plane ownership link for a bucket created outside
        this auth layer (the radosgw-admin `bucket link` role) —
        without it, unknown-owner buckets are denied to everyone."""
        if bucket not in self._gw.list_buckets():
            raise NoSuchBucket(bucket)
        self._owner[bucket] = uid

    def call(self, access_key: str, date: str, signature: str,
             op: str, bucket: str = "", key: str = "",
             nonce: str = "", payload: bytes = b"",
             **params):
        now = self._clock()
        # 1. clock skew gate BEFORE any signature math (ref order)
        if abs(now - _parse_amz_date(date)) > SKEW_MAX:
            raise RequestTimeTooSkewed(
                f"request time {date} outside +/-{SKEW_MAX:.0f}s")
        # 2. signature over exactly what will execute
        uid, secret = self._users.lookup(access_key)
        want = sign(secret, date, op, bucket, key, nonce, params,
                    bytes(payload))
        if not hmac.compare_digest(want, signature):
            raise SignatureDoesNotMatch(op)
        # 3. replay rejection inside the skew window — check+insert
        # atomically (per-connection reader threads submit in
        # parallel; a race here would execute a replay twice)
        with self._seen_lock:
            if len(self._seen) > 4096 \
                    and now - self._last_prune > 60.0:
                self._seen = {s: t for s, t in self._seen.items()
                              if t > now}
                self._last_prune = now
            if signature in self._seen:
                raise AccessDenied("replayed request")
            self._seen[signature] = now + 2 * SKEW_MAX
        # 4. authorization: bucket ownership (authN without authZ
        # would let any valid user delete any other user's data)
        if op not in self._OPS:
            raise AccessDenied(f"unknown op {op!r}")
        if op not in ("list_buckets", "create_bucket"):
            owner = self._owner.get(bucket)
            if owner != uid:
                raise AccessDenied(
                    f"bucket {bucket!r} is owned by another user"
                    if owner is not None else
                    f"bucket {bucket!r} has no recorded owner")
        # 5. dispatch (explicit binding per op: the signed bucket/key
        # must never re-bind to a different parameter slot)
        gw = self._gw
        if op == "list_buckets":
            # strict owner match: orphan buckets (no recorded owner)
            # must not appear in anyone's listing either
            return [b for b in gw.list_buckets()
                    if self._owner.get(b) == uid]
        if op == "create_bucket":
            out = gw.create_bucket(bucket)
            self._owner[bucket] = uid
            return out
        if op == "delete_bucket":
            out = gw.delete_bucket(bucket)
            self._owner.pop(bucket, None)
            return out
        if op == "list_objects":
            return gw.list_objects(bucket, **params)
        if op == "put_bucket_versioning":
            return gw.set_bucket_versioning(bucket, params["enabled"])
        if op == "get_bucket_versioning":
            return gw.get_bucket_versioning(bucket)
        if op == "list_object_versions":
            return gw.list_object_versions(bucket, **params)
        if op == "put_object":
            return gw.put_object(bucket, key, payload)
        if op == "copy_object":
            # the signed (bucket, key) is the DESTINATION; the source
            # bucket needs its own ownership check — authenticated
            # users must not read each other's buckets via copy
            # unknown-owner sources (buckets made on the raw Gateway,
            # outside this auth layer) are DENIED, not world-readable
            src_owner = self._owner.get(params["src_bucket"])
            if src_owner != uid:
                raise AccessDenied(
                    f"source bucket {params['src_bucket']!r} is "
                    "owned by another user" if src_owner is not None
                    else f"source bucket {params['src_bucket']!r} "
                    "has no recorded owner")
            return gw.copy_object(
                params["src_bucket"], params["src_key"], bucket, key,
                src_version_id=params.get("src_version_id"))
        if op == "upload_part":
            return gw.upload_part(bucket, key, params["upload_id"],
                                  params["part_number"], payload)
        if op in ("complete_multipart", "abort_multipart"):
            return getattr(gw, op)(bucket, key, params["upload_id"])
        # get_object / head_object / delete_object / initiate_multipart
        return getattr(gw, op)(bucket, key, **params)


class S3Client:
    """Client-side signer (the SDK role): stamps date + nonce, signs
    the canonical request, ships the call."""

    def __init__(self, authed: AuthedGateway, access_key: str,
                 secret_key: str, clock=time.time):
        self._a = authed
        self._access = access_key
        self._secret = secret_key
        self._clock = clock

    def _call(self, op: str, bucket: str = "", key: str = "",
              payload: bytes = b"", **params):
        date = amz_date(self._clock())
        nonce = os.urandom(8).hex()
        sig = sign(self._secret, date, op, bucket, key, nonce, params,
                   bytes(payload))
        return self._a.call(self._access, date, sig, op, bucket=bucket,
                            key=key, nonce=nonce, payload=payload,
                            **params)

    # -- the S3 surface, signed ----------------------------------------------

    def create_bucket(self, bucket):
        return self._call("create_bucket", bucket)

    def delete_bucket(self, bucket):
        return self._call("delete_bucket", bucket)

    def list_buckets(self):
        return self._call("list_buckets")

    def put_object(self, bucket, key, data: bytes):
        return self._call("put_object", bucket, key, payload=data)

    def get_object(self, bucket, key, offset: int = 0,
                   length: int | None = None,
                   version_id: str | None = None):
        return self._call("get_object", bucket, key, offset=offset,
                          length=length, version_id=version_id)

    def copy_object(self, src_bucket, src_key, dst_bucket, dst_key,
                    src_version_id: str | None = None):
        return self._call("copy_object", dst_bucket, dst_key,
                          src_bucket=src_bucket, src_key=src_key,
                          src_version_id=src_version_id)

    def head_object(self, bucket, key, version_id: str | None = None):
        return self._call("head_object", bucket, key,
                          version_id=version_id)

    def delete_object(self, bucket, key,
                      version_id: str | None = None):
        return self._call("delete_object", bucket, key,
                          version_id=version_id)

    def put_bucket_versioning(self, bucket, enabled: bool):
        return self._call("put_bucket_versioning", bucket,
                          enabled=enabled)

    def get_bucket_versioning(self, bucket):
        return self._call("get_bucket_versioning", bucket)

    def list_object_versions(self, bucket, prefix: str = ""):
        return self._call("list_object_versions", bucket,
                          prefix=prefix)

    def list_objects(self, bucket, prefix: str = "", marker: str = "",
                     limit: int = 1000, delimiter: str = ""):
        return self._call("list_objects", bucket, prefix=prefix,
                          marker=marker, limit=limit,
                          delimiter=delimiter)

    def initiate_multipart(self, bucket, key):
        return self._call("initiate_multipart", bucket, key)

    def upload_part(self, bucket, key, upload_id, part_number,
                    data: bytes):
        return self._call("upload_part", bucket, key, payload=data,
                          upload_id=upload_id, part_number=part_number)

    def complete_multipart(self, bucket, key, upload_id):
        return self._call("complete_multipart", bucket, key,
                          upload_id=upload_id)

    def abort_multipart(self, bucket, key, upload_id):
        return self._call("abort_multipart", bucket, key,
                          upload_id=upload_id)
