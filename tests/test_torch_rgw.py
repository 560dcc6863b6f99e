"""The port's RGW (buckets, objects, ranged gets, copies, prefix
listings, versioning, multipart, lifecycle) and its signing front
(rgw/auth: SigV4-style signatures, the skew window, the replay cache)
held against the JAX package's on the CPU, each over its own package's
librados and SimCluster (the port's with device="cpu"), at RS k=4 m=2
and k=8 m=3: every returned byte string, head, listing, version list,
signature, exception (class and message) and the Objecter's counters,
then every OSD's shards, xattrs and omap and the bucket indexes
(torch_client_helpers). The clock (the cluster's virtual one, and a
fixed one for auth) and os.urandom (upload ids, keys, nonces) are
pinned the same way for both. Tolerance: none."""

import numpy as np
import pytest

from torch_client_helpers import (PROFILES, counters, payload, run_both,
                                  seeded_urandom)

DAY = 86400.0
T0 = 1_780_000_000.0          # the signers' and the verifier's clock


def _gw(S, c):
    r = S.rados.Rados(c)
    return r, S.gateway.Gateway(r.open_ioctx())


def seq_objects(S, c, rec):
    rng = np.random.default_rng(31)
    r, gw = _gw(S, c)
    rec("create", gw.create_bucket, "b")
    rec("create again", gw.create_bucket, "b")
    rec("create other", gw.create_bucket, "c")
    rec("list_buckets", gw.list_buckets)
    for key, n in (("docs/a", 3000), ("docs/b", 10), ("img/x", 70000),
                   ("top", 0)):
        rec(f"put {key}", gw.put_object, "b", key, payload(rng, n))
    rec("put to a missing bucket", gw.put_object, "nope", "k", b"x")
    rec("get", gw.get_object, "b", "docs/a")
    rec("get range", gw.get_object, "b", "img/x", offset=65000,
        length=2000)
    rec("get missing", gw.get_object, "b", "docs/zz")
    rec("head", lambda: {k: v for k, v in gw.head_object("b", "img/x")
                         .items() if k != "mtime"})
    rec("copy", gw.copy_object, "b", "img/x", "c", "copied")
    rec("get copy", gw.get_object, "c", "copied")
    rec("overwrite", gw.put_object, "b", "docs/a", payload(rng, 100))
    rec("list prefix", gw.list_objects, "b", prefix="docs/")
    rec("list delimiter", gw.list_objects, "b", delimiter="/")
    rec("list limit", gw.list_objects, "b", limit=2)
    rec("delete", gw.delete_object, "b", "docs/b")
    rec("delete non-empty bucket", gw.delete_bucket, "c")
    rec("delete", gw.delete_object, "c", "copied")
    rec("delete bucket", gw.delete_bucket, "c")
    rec("list_buckets", gw.list_buckets)
    rec("list", gw.list_objects, "b")
    rec.note("counters", counters(r))


def seq_versions_multipart(S, c, rec):
    rng = np.random.default_rng(32)
    r, gw = _gw(S, c)
    gw.create_bucket("v")
    rec("versioning", gw.get_bucket_versioning, "v")
    rec("enable", gw.set_bucket_versioning, "v", True)
    for i in range(3):
        rec(f"put v{i}", gw.put_object, "v", "k", payload(rng, 500 + i))
    listing = rec("versions", gw.list_object_versions, "v")
    vids = [v["vid"] for v in listing["versions"]][::-1]
    rec("get current", gw.get_object, "v", "k")
    rec("get first", gw.get_object, "v", "k", version_id=vids[0])
    rec("delete (marker)", gw.delete_object, "v", "k")
    rec("get after marker", gw.get_object, "v", "k")
    rec("versions", gw.list_object_versions, "v")
    rec("delete a version", gw.delete_object, "v", "k",
        version_id=vids[1])
    rec("versions", gw.list_object_versions, "v", prefix="k")
    up = rec("initiate", gw.initiate_multipart, "v", "big")
    parts = [payload(rng, 6000 + 100 * i) for i in range(3)]
    for i, part in enumerate(parts):
        rec(f"upload part {i + 1}", gw.upload_part, "v", "big", up, i + 1,
            part)
    rec("upload to a missing upload", gw.upload_part, "v", "big", "u0", 1,
        b"x")
    rec("complete", gw.complete_multipart, "v", "big", up)
    rec("get multipart", gw.get_object, "v", "big")
    rec("get multipart range", gw.get_object, "v", "big", offset=5999,
        length=6002)
    up2 = rec("initiate", gw.initiate_multipart, "v", "gone")
    rec("upload", gw.upload_part, "v", "gone", up2, 1, payload(rng, 100))
    rec("abort", gw.abort_multipart, "v", "gone", up2)
    rec("complete aborted", gw.complete_multipart, "v", "gone", up2)
    rec("list", gw.list_objects, "v")
    rec.note("counters", counters(r))


def seq_lifecycle(S, c, rec):
    rng = np.random.default_rng(33)
    r, gw = _gw(S, c)
    gw.create_bucket("l")
    rec("empty rules", gw.put_bucket_lifecycle, "l", [])
    rec("put rules", gw.put_bucket_lifecycle, "l", [
        {"id": "tmp", "prefix": "tmp/", "status": "Enabled",
         "expiration_days": 3},
        {"id": "old", "status": "Enabled",
         "noncurrent_days": 1}])
    rec("get rules", gw.get_bucket_lifecycle, "l")
    for key in ("tmp/a", "tmp/b", "keep/c"):
        gw.put_object("l", key, payload(rng, 300))
    c.now += 2 * DAY
    rec("lc too early", gw.lc_process)
    gw.put_object("l", "tmp/new", payload(rng, 300))
    c.now += 2 * DAY
    rec("lc", gw.lc_process)
    rec("list", gw.list_objects, "l")
    rec("delete rules", gw.delete_bucket_lifecycle, "l")
    c.now += 10 * DAY
    rec("lc without rules", gw.lc_process)
    rec.note("counters", counters(r))


def seq_auth(S, c, rec):
    rng = np.random.default_rng(34)
    r, gw = _gw(S, c)
    users = S.auth.UserStore()
    ak, sk = rec("create_user", users.create_user, "alice")
    bk, bs = users.create_user("bob")
    agw = S.auth.AuthedGateway(gw, users, clock=lambda: T0)
    s3 = S.auth.S3Client(agw, ak, sk, clock=lambda: T0)
    rec("signed create", s3.create_bucket, "ab")
    rec("signed put", s3.put_object, "ab", "k", payload(rng, 2000))
    rec("signed get", s3.get_object, "ab", "k", offset=3, length=10)
    rec("signed list", s3.list_objects, "ab")
    rec("signature", S.auth.sign, sk, S.auth.amz_date(T0), "put_object",
        "ab", "k", "n0", {}, b"data")
    date = S.auth.amz_date(T0)
    good = S.auth.sign(sk, date, "get_object", "ab", "k", "n1", {}, b"")
    rec("accepted", agw.call, ak, date, good, "get_object", "ab", "k",
        nonce="n1")
    rec("replayed", agw.call, ak, date, good, "get_object", "ab", "k",
        nonce="n1")
    rec("tampered key", agw.call, ak, date, good, "get_object", "ab",
        "other", nonce="n1")
    rec("tampered payload", agw.call, ak, date,
        S.auth.sign(sk, date, "put_object", "ab", "k", "n2", {}, b"a"),
        "put_object", "ab", "k", nonce="n2", payload=b"b")
    skewed = S.auth.amz_date(T0 - 1200.0)
    rec("skewed", agw.call, ak, skewed,
        S.auth.sign(sk, skewed, "get_object", "ab", "k", "n3", {}, b""),
        "get_object", "ab", "k", nonce="n3")
    rec("unknown key", agw.call, "AKNOPE", date, good, "get_object", "ab",
        "k", nonce="n1")
    bob = S.auth.S3Client(agw, bk, bs, clock=lambda: T0)
    rec("another owner's bucket", bob.get_object, "ab", "k")
    rec("bob's buckets", bob.list_buckets)
    rec("wrong secret", S.auth.S3Client(agw, ak, "x" * 40,
                                        clock=lambda: T0).list_buckets)
    rec.note("counters", counters(r))


SEQUENCES = {"objects": seq_objects,
             "versions_multipart": seq_versions_multipart,
             "lifecycle": seq_lifecycle, "auth": seq_auth}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_rgw_sequence_matches_twin(name, profile, monkeypatch):
    restart = seeded_urandom(monkeypatch, 35)
    run_both(SEQUENCES[name], PROFILES[profile], restart=restart)
