"""RGW-lite — the S3-shaped object gateway over rados.

Rebuild of the reference's radosgw data path (ref: src/rgw/ —
rgw_op.cc RGWPutObj/RGWGetObj/RGWDeleteObj/RGWListBucket,
rgw_rados.cc head+tail object layout, cls/rgw/cls_rgw.cc bucket-index
omap ops, multipart assembly in rgw_multi.cc). What's kept and how it
maps onto this framework:

* BUCKETS + INDEX. Each bucket has an index object whose entries are
  maintained by a server-side object class (`rgw_index` below) — the
  exact role cls_rgw plays for the reference: the index mutates
  atomically AT the object, not read-modify-write from the client.
  Listing supports prefix + marker pagination like ListObjectsV2.
* OBJECT LAYOUT. Small objects land in one rados object; everything
  is written through the RadosStriper, so big S3 objects stripe
  across rados objects exactly as RGW's head+tails do. ETag =
  hex(crc32c) of the payload (the reference uses MD5; the framework's
  native checksum keeps the property that matters — content-derived,
  verified end to end).
* MULTIPART. initiate/upload_part/complete/abort: parts are striped
  objects of their own; complete writes a MANIFEST the GET path
  follows (RGW's multipart manifest), so completion is O(parts), not
  a data rewrite.
* S3-AUTH lives in auth.py (SigV4-shaped canonical requests, HMAC
  key-derivation chain, skew window, replay cache) as a verifying
  front over this gateway.
* VERSIONING (ref: rgw_bucket_dir_entry instance entries +
  RGWRados olh/instance objects; S3 bucket versioning semantics).
  Bucket state Off -> Enabled <-> Suspended via the index cls; a
  versioned PUT appends an instance entry whose payload lives at its
  own soid (.v.{vid}); unversioned DELETE writes a delete marker;
  DELETE with versionId permanently removes that instance + payload;
  Suspended writes/overwrites the "null" version; GET/HEAD accept
  version_id; ListObjectVersions reports history newest-first with
  is_latest and markers. Objects predating versioning materialize as
  the null version on first versioned write (payload stays at the
  legacy soid).

Everything routes through librados/striper, so EC encode fan-out,
snapshots' COW, scrub, recovery, and PG splits all apply to gateway
data with no special cases."""

from __future__ import annotations

import json
import time

from ..client.rados import IoCtx, RadosStriper
from ..osd.objclass import ClsError, ClsHandle, register_cls

_BUCKETS_ROOT = ".rgw.root"          # object listing all buckets


class GatewayError(Exception):
    pass


class NoSuchBucket(GatewayError, KeyError):
    pass


class NoSuchKey(GatewayError, KeyError):
    pass


# -- bucket index object class (the cls_rgw role) ----------------------------

@register_cls("rgw_index", "add")
def _idx_add(h: ClsHandle, inp: bytes) -> bytes:
    ent = json.loads(inp)
    idx = h.kv.setdefault("entries", {})
    idx[ent["key"]] = {"size": ent["size"], "etag": ent["etag"],
                       "mtime": ent["mtime"]}
    return b"{}"


@register_cls("rgw_index", "rm")
def _idx_rm(h: ClsHandle, inp: bytes) -> bytes:
    key = json.loads(inp)["key"]
    idx = h.kv.setdefault("entries", {})
    if key not in idx:
        raise ClsError(f"ENOENT: {key}")
    del idx[key]
    return b"{}"


@register_cls("rgw_index", "list")
def _idx_list(h: ClsHandle, inp: bytes) -> bytes:
    """ListObjectsV2 shape incl. `delimiter` rollup: keys sharing
    prefix..delimiter collapse into common_prefixes (the S3 "folder"
    view; ref: cls_rgw bucket listing + RGWListBucket::execute)."""
    req = json.loads(inp or b"{}")
    prefix = req.get("prefix", "")
    marker = req.get("marker", "")
    delim = req.get("delimiter", "")
    limit = int(req.get("limit", 1000))
    idx = h.kv.get("entries", {})
    if not delim:
        keys = sorted(k for k in idx
                      if k.startswith(prefix) and k > marker)
        page = keys[:limit]
        return json.dumps({
            "entries": [{"key": k, **idx[k]} for k in page],
            "truncated": len(keys) > limit,
            "next_marker": page[-1] if page and len(keys) > limit
            else "",
        }).encode()
    # S3 marker semantics: keys strictly after the marker, THEN the
    # rollup — except that a marker which IS a rolled-up prefix (our
    # next_marker after a delimiter page) skips everything under it,
    # or pagination would re-emit the prefix forever. A plain-key
    # marker inside a prefix still surfaces that prefix for the
    # remaining keys, as S3 does.
    entries, prefixes, taken = [], [], 0
    last = ""
    more = False
    # a rolled-up-prefix marker is always STRICTLY longer than the
    # listing prefix (rollup appends at least one char + delim), so
    # marker == prefix can only be a real zero-byte "folder marker"
    # object ('a/' listed as an ENTRY under prefix='a/') — treating
    # it as a rollup would silently skip the whole subtree
    marker_is_prefix = bool(marker) and marker.endswith(delim) \
        and marker != prefix
    for k in sorted(k for k in idx if k.startswith(prefix)):
        if k <= marker:
            continue
        if marker_is_prefix and k.startswith(marker):
            continue         # under an already-listed rollup page
        rest = k[len(prefix):]
        cut = rest.find(delim)
        rolled = prefix + rest[:cut + len(delim)] if cut >= 0 else k
        if cut >= 0 and prefixes and prefixes[-1] == rolled:
            last = rolled        # absorbed into the current rollup
            continue
        if taken >= limit:
            more = True
            break
        if cut >= 0:
            prefixes.append(rolled)
        else:
            entries.append({"key": k, **idx[k]})
        taken += 1
        last = rolled
    return json.dumps({
        "entries": entries, "common_prefixes": prefixes,
        "truncated": more,
        "next_marker": last if more else "",
    }).encode()


@register_cls("rgw_index", "set_manifest")
def _idx_set_manifest(h: ClsHandle, inp: bytes) -> bytes:
    req = json.loads(inp)
    ent = h.kv.get("entries", {}).get(req["key"])
    if ent is None:
        raise ClsError(f"ENOENT: {req['key']}")
    ent["manifest"] = req["manifest"]
    ent["part_sizes"] = req["part_sizes"]
    return b"{}"


@register_cls("rgw_index", "stat")
def _idx_stat(h: ClsHandle, inp: bytes) -> bytes:
    key = json.loads(inp)["key"]
    ent = h.kv.get("entries", {}).get(key)
    if ent is None:
        raise ClsError(f"ENOENT: {key}")
    return json.dumps(ent).encode()


# -- lifecycle configuration (cls-held, ref: RGWLC + cls_rgw lc ops) --

@register_cls("rgw_index", "set_lc")
def _idx_set_lc(h: ClsHandle, inp: bytes) -> bytes:
    h.kv["lifecycle"] = json.loads(inp)
    return b"{}"


@register_cls("rgw_index", "get_lc")
def _idx_get_lc(h: ClsHandle, inp: bytes) -> bytes:
    return json.dumps(h.kv.get("lifecycle", [])).encode()


@register_cls("rgw_index", "del_lc")
def _idx_del_lc(h: ClsHandle, inp: bytes) -> bytes:
    h.kv.pop("lifecycle", None)
    return b"{}"


# -- versioning (cls_rgw bucket-index instance entries, ref:
#    rgw_bucket_dir_entry instances + RGWRados::Bucket::UpdateIndex;
#    S3 semantics: PUT appends a version, unversioned DELETE writes a
#    delete marker, Suspended writes/overwrites the "null" version) --

def _idx_current_view(ent: dict) -> dict:
    """The entries{} (latest-view) projection of a version entry."""
    view = {"size": ent["size"], "etag": ent["etag"],
            "mtime": ent["mtime"], "vid": ent["vid"]}
    for f in ("soid", "manifest", "part_sizes"):
        if f in ent:
            view[f] = ent[f]
    return view


@register_cls("rgw_index", "set_versioning")
def _idx_set_versioning(h: ClsHandle, inp: bytes) -> bytes:
    status = json.loads(inp)["status"]
    if status not in ("Enabled", "Suspended"):
        raise ClsError(f"bad versioning status {status!r}")
    h.kv["versioning"] = status
    return b"{}"


@register_cls("rgw_index", "get_versioning")
def _idx_get_versioning(h: ClsHandle, inp: bytes) -> bytes:
    # "Off" = never enabled (S3: unversioned bucket); once enabled a
    # bucket can only flip Enabled <-> Suspended
    return json.dumps({"status": h.kv.get("versioning", "Off")}).encode()


@register_cls("rgw_index", "alloc_vid")
def _idx_alloc_vid(h: ClsHandle, inp: bytes) -> bytes:
    n = h.kv.get("next_vid", 1)
    h.kv["next_vid"] = n + 1
    return json.dumps({"vid": f"v{n:08d}"}).encode()


@register_cls("rgw_index", "put_version")
def _idx_put_version(h: ClsHandle, inp: bytes) -> bytes:
    """Append a version entry (newest LAST) and refresh the latest
    view. A 'null' vid replaces any existing null entry (Suspended
    semantics); the replaced entry is returned so the caller can wipe
    its payload. If the key predates versioning, its legacy entry is
    first materialized as the null version (payload at legacy_soid)."""
    req = json.loads(inp)
    key, ent = req["key"], req["ent"]
    versions = h.kv.setdefault("versions", {})
    entries = h.kv.setdefault("entries", {})
    lst = versions.setdefault(key, [])
    if not lst and key in entries and "vid" not in entries[key]:
        legacy = dict(entries[key])
        legacy.update(vid="null", delete_marker=False,
                      soid=req["legacy_soid"])
        lst.append(legacy)
    replaced = None
    if ent["vid"] == "null":
        for i, v in enumerate(lst):
            if v["vid"] == "null":
                replaced = lst.pop(i)
                break
    lst.append(ent)
    if ent.get("delete_marker"):
        entries.pop(key, None)
    else:
        entries[key] = _idx_current_view(ent)
    return json.dumps({"replaced": replaced}).encode()


@register_cls("rgw_index", "rm_version")
def _idx_rm_version(h: ClsHandle, inp: bytes) -> bytes:
    """Remove ONE version (S3 DELETE with versionId) and recompute
    the latest view from what remains. Returns the removed entry so
    the caller wipes its payload."""
    req = json.loads(inp)
    key, vid = req["key"], req["vid"]
    versions = h.kv.get("versions", {})
    lst = versions.get(key, [])
    removed = None
    for i, v in enumerate(lst):
        if v["vid"] == vid:
            removed = lst.pop(i)
            break
    if removed is None:
        raise ClsError(f"NoSuchVersion: {key}@{vid}")
    entries = h.kv.setdefault("entries", {})
    if not lst:
        versions.pop(key, None)
        entries.pop(key, None)
    elif lst[-1].get("delete_marker"):
        entries.pop(key, None)
    else:
        entries[key] = _idx_current_view(lst[-1])
    return json.dumps(removed).encode()


@register_cls("rgw_index", "has_versions")
def _idx_has_versions(h: ClsHandle, inp: bytes) -> bytes:
    """O(1) membership probe: key given -> that key has history;
    no key -> ANY key does (the delete_bucket emptiness check)."""
    key = json.loads(inp or b"{}").get("key")
    versions = h.kv.get("versions", {})
    if key is None:
        any_v = any(bool(v) for v in versions.values())
    else:
        any_v = bool(versions.get(key))
    return json.dumps({"any": any_v}).encode()


@register_cls("rgw_index", "stat_version")
def _idx_stat_version(h: ClsHandle, inp: bytes) -> bytes:
    req = json.loads(inp)
    for v in h.kv.get("versions", {}).get(req["key"], []):
        if v["vid"] == req["vid"]:
            return json.dumps(v).encode()
    raise ClsError(f"NoSuchVersion: {req['key']}@{req['vid']}")


@register_cls("rgw_index", "list_versions")
def _idx_list_versions(h: ClsHandle, inp: bytes) -> bytes:
    """ListObjectVersions shape: per key newest-first, is_latest on
    the newest, delete markers included."""
    req = json.loads(inp or b"{}")
    prefix = req.get("prefix", "")
    versions = h.kv.get("versions", {})
    out = []
    for key in sorted(k for k in versions if k.startswith(prefix)):
        for i, v in enumerate(reversed(versions[key])):
            out.append({"key": key, "vid": v["vid"],
                        "is_latest": i == 0,
                        "delete_marker": bool(v.get("delete_marker")),
                        "size": v["size"], "etag": v["etag"],
                        "mtime": v["mtime"]})
    return json.dumps({"versions": out}).encode()


class Gateway:
    """One S3-facing endpoint over an IoCtx (the radosgw process)."""

    #: striping geometry for object payloads (RGW head+tail analog)
    STRIPE_UNIT = 1 << 16
    STRIPE_COUNT = 4
    OBJECT_SIZE = 1 << 20

    def __init__(self, ioctx: IoCtx):
        self.io = ioctx
        self._striper = RadosStriper(
            ioctx, stripe_unit=self.STRIPE_UNIT,
            stripe_count=self.STRIPE_COUNT,
            object_size=self.OBJECT_SIZE)

    # -- naming --------------------------------------------------------------

    @staticmethod
    def _index_obj(bucket: str) -> str:
        return f".bucket.index.{bucket}"

    @staticmethod
    def _data_obj(bucket: str, key: str) -> str:
        return f".bucket.data.{bucket}/{key}"

    @staticmethod
    def _upload_obj(bucket: str, key: str, upload_id: str,
                    part: int | None = None) -> str:
        base = f".bucket.multipart.{bucket}/{key}/{upload_id}"
        return base if part is None else f"{base}/part.{part:05d}"

    def _clock(self) -> float:
        from ..client.rados import sim_clock
        return sim_clock(self.io)

    def _etag(self, data: bytes) -> str:
        from ..osd.tinstore import _crc32c
        return f"{_crc32c(data):08x}"

    # -- buckets -------------------------------------------------------------

    def create_bucket(self, bucket: str) -> None:
        if not bucket or "/" in bucket:
            raise GatewayError(f"bad bucket name {bucket!r}")
        roots = self._root_read()
        if bucket in roots:
            raise GatewayError(f"BucketAlreadyExists: {bucket}")
        self.io.write_full(self._index_obj(bucket), b"index")
        roots.append(bucket)
        self._root_write(roots)

    def delete_bucket(self, bucket: str) -> None:
        self._check_bucket(bucket)
        listing = self.list_objects(bucket, limit=1)
        if listing["entries"]:
            raise GatewayError(f"BucketNotEmpty: {bucket}")
        out = json.loads(self.io.execute(
            self._index_obj(bucket), "rgw_index", "has_versions"))
        if out["any"]:
            # S3: noncurrent versions and delete markers also block
            # bucket deletion — their payloads would orphan
            raise GatewayError(f"BucketNotEmpty: {bucket} "
                               f"(noncurrent versions remain)")
        self.io.remove(self._index_obj(bucket))
        roots = self._root_read()
        roots.remove(bucket)
        self._root_write(roots)

    def list_buckets(self) -> list[str]:
        return sorted(self._root_read())

    def _root_read(self) -> list[str]:
        try:
            return json.loads(self.io.read(_BUCKETS_ROOT))
        except KeyError:
            return []

    def _root_write(self, roots: list[str]) -> None:
        self.io.write_full(_BUCKETS_ROOT, json.dumps(sorted(roots)).encode())

    def _check_bucket(self, bucket: str) -> None:
        try:
            self.io.stat(self._index_obj(bucket))
        except KeyError:
            raise NoSuchBucket(bucket) from None

    # -- versioning ----------------------------------------------------------

    @staticmethod
    def _vdata_obj(bucket: str, key: str, vid: str) -> str:
        # A namespace of its own, collision-free by construction:
        # '.bucket.vdata.' is disjoint from _data_obj/_upload_obj
        # prefixes; '/' joins bucket to key exactly like _data_obj
        # ('.'-joining would let ('b.k','x') and ('b','k.x') share a
        # soid — bucket names may contain '.'); and within the
        # namespace (key, vid) -> f"{key}.v.{vid}" is injective
        # because vids match ^(null|v\d{8})$ — suffixes of equal vids
        # force equal keys, and 'null' vs 'v\d{8}' differ in both
        # length-tail and final character, so no key can absorb the
        # difference.
        return f".bucket.vdata.{bucket}/{key}.v.{vid}"

    def set_bucket_versioning(self, bucket: str, enabled: bool) -> None:
        """PutBucketVersioning: Enabled / Suspended (a bucket that was
        ever versioned cannot return to Off — S3 semantics)."""
        self._check_bucket(bucket)
        self.io.execute(self._index_obj(bucket), "rgw_index",
                        "set_versioning", json.dumps(
                            {"status": "Enabled" if enabled
                             else "Suspended"}).encode())

    def get_bucket_versioning(self, bucket: str) -> str:
        self._check_bucket(bucket)
        return self._versioning(bucket)

    def _versioning(self, bucket: str) -> str:
        out = self.io.execute(self._index_obj(bucket), "rgw_index",
                              "get_versioning")
        return json.loads(out)["status"]

    def _alloc_vid(self, bucket: str) -> str:
        out = self.io.execute(self._index_obj(bucket), "rgw_index",
                              "alloc_vid")
        return json.loads(out)["vid"]

    def _put_version(self, bucket: str, key: str, ent: dict) -> None:
        """Record a version entry; wipe whatever payload a replaced
        null version owned (Suspended-overwrite semantics)."""
        out = self.io.execute(
            self._index_obj(bucket), "rgw_index", "put_version",
            json.dumps({"key": key, "ent": ent,
                        "legacy_soid": self._data_obj(bucket, key)}
                       ).encode())
        replaced = json.loads(out)["replaced"]
        if replaced is not None:
            self._wipe_version_payload(replaced, keep=ent.get("soid"))

    def _next_vid(self, bucket: str, status: str) -> str:
        """Fresh vid under Enabled; the null slot under Suspended."""
        return self._alloc_vid(bucket) if status == "Enabled" else "null"

    def _record_version(self, bucket: str, key: str, vid: str,
                        **fields) -> str:
        """Shared versioned-write tail: record the entry (mtime
        stamped, live unless delete_marker overridden), return the
        vid. `fields` supplies size/etag/soid/manifest/..."""
        ent = {"vid": vid, "mtime": self._clock(),
               "delete_marker": False, **fields}
        self._put_version(bucket, key, ent)
        return vid

    def _wipe_version_payload(self, ent: dict,
                              keep: str | None = None) -> None:
        if "manifest" in ent:
            for part_soid in ent["manifest"]:
                self._wipe_striped(part_soid)
        elif ent.get("soid") and ent["soid"] != keep:
            self._wipe_striped(ent["soid"])

    def list_object_versions(self, bucket: str,
                             prefix: str = "") -> dict:
        """ListObjectVersions: every version + delete marker, per key
        newest-first with is_latest on the newest."""
        self._check_bucket(bucket)
        out = self.io.execute(self._index_obj(bucket), "rgw_index",
                              "list_versions",
                              json.dumps({"prefix": prefix}).encode())
        return json.loads(out)

    # -- objects -------------------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes) -> str:
        """PUT: payload through the striper, then the index entry via
        the cls (atomic at the index object). Returns the ETag.
        Versioned buckets append a new version (Enabled) or replace
        the null version (Suspended) instead of overwriting."""
        self._check_bucket(bucket)
        if not key:
            raise GatewayError("empty key")
        data = bytes(data)
        etag = self._etag(data)
        status = self._versioning(bucket)
        if status != "Off":
            vid = self._next_vid(bucket, status)
            soid = self._vdata_obj(bucket, key, vid)
            self._wipe_striped(soid)     # null overwrite-in-place
            self._striper.write(soid, data)
            self._record_version(bucket, key, vid, soid=soid,
                                 size=len(data), etag=etag)
            return etag
        soid = self._data_obj(bucket, key)
        self._wipe_replaced(bucket, key)
        self._wipe_striped(soid)
        self._striper.write(soid, data)
        self.io.execute(self._index_obj(bucket), "rgw_index", "add",
                        json.dumps({"key": key, "size": len(data),
                                    "etag": etag,
                                    "mtime": self._clock()}).encode())
        return etag

    def _stat_version(self, bucket: str, key: str, vid: str) -> dict:
        try:
            return json.loads(self.io.execute(
                self._index_obj(bucket), "rgw_index", "stat_version",
                json.dumps({"key": key, "vid": vid}).encode()))
        except ClsError:
            raise NoSuchKey(f"{bucket}/{key}@{vid}") from None

    def get_object(self, bucket: str, key: str,
                   offset: int = 0, length: int | None = None,
                   version_id: str | None = None) -> bytes:
        self._check_bucket(bucket)
        if version_id is not None:
            ent = self._stat_version(bucket, key, version_id)
            if ent.get("delete_marker"):
                raise NoSuchKey(f"{bucket}/{key}@{version_id} "
                                f"is a delete marker")
        else:
            ent = self._stat_entry(bucket, key)
        if "manifest" in ent:
            return self._read_manifest(bucket, key, ent, offset, length)
        soid = ent.get("soid") or self._data_obj(bucket, key)
        try:
            if length is None:
                length = max(0, ent["size"] - offset)
            return self._striper.read(soid, length=length, offset=offset)
        except KeyError:
            raise NoSuchKey(f"{bucket}/{key}") from None

    def head_object(self, bucket: str, key: str,
                    version_id: str | None = None) -> dict:
        self._check_bucket(bucket)
        if version_id is not None:
            ent = self._stat_version(bucket, key, version_id)
            if ent.get("delete_marker"):
                # S3 fails HEAD on a marker too (405 +
                # x-amz-delete-marker); succeeding here while GET
                # refuses would split the surface
                raise NoSuchKey(f"{bucket}/{key}@{version_id} "
                                f"is a delete marker")
            return ent
        return self._stat_entry(bucket, key)

    def delete_object(self, bucket: str, key: str,
                      version_id: str | None = None) -> dict:
        """DELETE. Unversioned bucket: remove key + payload. Versioned,
        no version_id: write a delete marker (payloads stay). With
        version_id: permanently remove THAT version and its payload.
        Returns {'delete_marker': bool, 'version_id': str|None}."""
        self._check_bucket(bucket)
        status = self._versioning(bucket)
        if version_id is not None:
            if status == "Off":
                raise NoSuchKey(f"{bucket}/{key}@{version_id}")
            try:
                removed = json.loads(self.io.execute(
                    self._index_obj(bucket), "rgw_index", "rm_version",
                    json.dumps({"key": key,
                                "vid": version_id}).encode()))
            except ClsError:
                raise NoSuchKey(f"{bucket}/{key}@{version_id}") \
                    from None
            self._wipe_version_payload(removed)
            return {"delete_marker": bool(removed.get("delete_marker")),
                    "version_id": version_id}
        if status != "Off":
            # a marker needs SOMETHING to mark: a current entry or
            # existing version history (S3 would even mark a
            # never-seen key; refusing those keeps delete-of-nothing
            # an error, consistent with the unversioned path)
            try:
                self._stat_entry(bucket, key)
            except NoSuchKey:
                out = json.loads(self.io.execute(
                    self._index_obj(bucket), "rgw_index",
                    "has_versions", json.dumps({"key": key}).encode()))
                if not out["any"]:
                    raise
            vid = self._record_version(
                bucket, key, self._next_vid(bucket, status),
                size=0, etag="", delete_marker=True)
            return {"delete_marker": True, "version_id": vid}
        ent = self._stat_entry(bucket, key)
        if "manifest" in ent:
            for part_soid in ent["manifest"]:
                self._wipe_striped(part_soid)
        else:
            self._wipe_striped(self._data_obj(bucket, key))
        self.io.execute(self._index_obj(bucket), "rgw_index", "rm",
                        json.dumps({"key": key}).encode())
        return {"delete_marker": False, "version_id": None}

    def copy_object(self, src_bucket: str, src_key: str,
                    dst_bucket: str, dst_key: str,
                    src_version_id: str | None = None) -> str:
        """CopyObject (ref: rgw_op.cc RGWCopyObj; S3
        x-amz-copy-source): server-side copy — the client never
        carries the bytes. The destination is a normal PUT (fresh
        payload objects, fresh mtime, versioning semantics of the
        DESTINATION bucket apply); the source may be a specific
        version. Returns the new ETag."""
        self._check_bucket(src_bucket)
        self._check_bucket(dst_bucket)
        if src_bucket == dst_bucket and src_key == dst_key \
                and src_version_id is None:
            # S3 rejects an in-place copy with no changes
            raise GatewayError(
                "InvalidRequest: copy onto itself without a source "
                "version changes nothing")
        data = self.get_object(src_bucket, src_key,
                               version_id=src_version_id)
        return self.put_object(dst_bucket, dst_key, data)

    def list_objects(self, bucket: str, prefix: str = "",
                     marker: str = "", limit: int = 1000,
                     delimiter: str = "") -> dict:
        """ListObjectsV2 shape: {entries, truncated, next_marker} plus
        common_prefixes when a delimiter rolls up "folders"."""
        self._check_bucket(bucket)
        out = self.io.execute(
            self._index_obj(bucket), "rgw_index", "list",
            json.dumps({"prefix": prefix, "marker": marker,
                        "limit": limit,
                        "delimiter": delimiter}).encode())
        return json.loads(out)

    def _stat_entry(self, bucket: str, key: str) -> dict:
        try:
            return json.loads(self.io.execute(
                self._index_obj(bucket), "rgw_index", "stat",
                json.dumps({"key": key}).encode()))
        except ClsError:
            raise NoSuchKey(f"{bucket}/{key}") from None

    def _wipe_striped(self, soid: str) -> None:
        try:
            self._striper.remove(soid)
        except KeyError:
            pass

    def _wipe_replaced(self, bucket: str, key: str) -> None:
        """Overwrite cleanup shared by every writer that replaces an
        index entry (put_object AND complete_multipart): the index
        'add' drops any existing manifest wholesale, so a replaced
        multipart object's part payloads must be wiped NOW or they
        orphan forever; a replaced plain object's data object is wiped
        by the writer that owns its soid."""
        try:
            old = self._stat_entry(bucket, key)
        except NoSuchKey:
            return
        if "manifest" in old:
            for part_soid in old["manifest"]:
                self._wipe_striped(part_soid)

    # -- multipart -----------------------------------------------------------

    def initiate_multipart(self, bucket: str, key: str) -> str:
        self._check_bucket(bucket)
        # random, not clock-derived: two initiates within one virtual
        # clock tick must not collide (upstream upload ids are opaque
        # unique strings too)
        import os as _os
        upload_id = f"u{_os.urandom(8).hex()}"
        self.io.write_full(self._upload_obj(bucket, key, upload_id),
                           json.dumps({"parts": {}}).encode())
        return upload_id

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes) -> str:
        if part_number < 1:
            raise GatewayError("part numbers start at 1")
        meta_obj = self._upload_obj(bucket, key, upload_id)
        try:
            meta = json.loads(self.io.read(meta_obj))
        except KeyError:
            raise GatewayError(f"NoSuchUpload: {upload_id}") from None
        soid = self._upload_obj(bucket, key, upload_id, part_number)
        self._wipe_striped(soid)
        self._striper.write(soid, bytes(data))
        etag = self._etag(bytes(data))
        meta["parts"][str(part_number)] = {"size": len(data),
                                           "etag": etag}
        self.io.write_full(meta_obj, json.dumps(meta).encode())
        return etag

    def complete_multipart(self, bucket: str, key: str,
                           upload_id: str) -> str:
        """Assemble by MANIFEST (no data rewrite): the index entry
        records the part objects; GET stitches them on read."""
        meta_obj = self._upload_obj(bucket, key, upload_id)
        try:
            meta = json.loads(self.io.read(meta_obj))
        except KeyError:
            raise GatewayError(f"NoSuchUpload: {upload_id}") from None
        parts = sorted(((int(n), p) for n, p in meta["parts"].items()))
        if not parts:
            raise GatewayError("no parts uploaded")
        manifest = [self._upload_obj(bucket, key, upload_id, n)
                    for n, _ in parts]
        sizes = [p["size"] for _, p in parts]
        etag = self._etag("".join(p["etag"] for _, p in parts).encode()) \
            + f"-{len(parts)}"
        status = self._versioning(bucket)
        if status != "Off":
            # versioned completion: the manifest IS the version's
            # payload (part objects are unique per upload_id, so
            # history never collides); nothing existing is wiped
            # except a replaced null version under Suspended
            self._record_version(
                bucket, key, self._next_vid(bucket, status),
                size=sum(sizes), etag=etag, manifest=manifest,
                part_sizes=sizes)
            self.io.remove(meta_obj)
            return etag
        # replacing an existing entry: wipe a previous upload's
        # manifest parts AND a previous plain object's data (the new
        # entry is manifest-backed, so the plain soid would orphan)
        self._wipe_replaced(bucket, key)
        self._wipe_striped(self._data_obj(bucket, key))
        self.io.execute(self._index_obj(bucket), "rgw_index", "add",
                        json.dumps({"key": key, "size": sum(sizes),
                                    "etag": etag,
                                    "mtime": self._clock()}).encode())
        self.io.execute(self._index_obj(bucket), "rgw_index",
                        "set_manifest",
                        json.dumps({"key": key, "manifest": manifest,
                                    "part_sizes": sizes}).encode())
        self.io.remove(meta_obj)
        return etag

    def abort_multipart(self, bucket: str, key: str,
                        upload_id: str) -> None:
        meta_obj = self._upload_obj(bucket, key, upload_id)
        try:
            meta = json.loads(self.io.read(meta_obj))
        except KeyError:
            raise GatewayError(f"NoSuchUpload: {upload_id}") from None
        for n in meta["parts"]:
            self._wipe_striped(
                self._upload_obj(bucket, key, upload_id, int(n)))
        self.io.remove(meta_obj)

    def _read_manifest(self, bucket: str, key: str, ent: dict,
                       offset: int, length: int | None) -> bytes:
        total = ent["size"]
        if length is None:
            length = max(0, total - offset)
        end = min(offset + length, total)
        out = bytearray()
        pos = 0
        for soid, size in zip(ent["manifest"], ent["part_sizes"]):
            pstart, pend = pos, pos + size
            lo, hi = max(offset, pstart), min(end, pend)
            if lo < hi:
                out += self._striper.read(soid, length=hi - lo,
                                          offset=lo - pstart)
            pos = pend
            if pos >= end:
                break
        return bytes(out)

    # -- lifecycle (ref: src/rgw/rgw_lc.cc RGWLC::process; S3
    #    Put/Get/DeleteBucketLifecycleConfiguration) -----------------------

    _LC_DAY = 86400.0

    def put_bucket_lifecycle(self, bucket: str,
                             rules: list[dict]) -> None:
        """Install lifecycle rules. Each rule: {id, prefix?, status
        Enabled|Disabled, expiration_days? and/or noncurrent_days?}
        — the S3 Expiration / NoncurrentVersionExpiration actions."""
        self._check_bucket(bucket)
        if not rules:
            raise GatewayError("MalformedXML: empty rule list")
        seen = set()
        for r in rules:
            rid = r.get("id")
            if not rid or rid in seen:
                raise GatewayError(
                    f"InvalidArgument: missing/duplicate rule id {rid!r}")
            seen.add(rid)
            if r.get("status", "Enabled") not in ("Enabled", "Disabled"):
                raise GatewayError(
                    f"MalformedXML: bad status in rule {rid!r}")
            days = r.get("expiration_days")
            ncdays = r.get("noncurrent_days")
            if days is None and ncdays is None:
                raise GatewayError(
                    f"InvalidRequest: rule {rid!r} has no action")
            for v in (days, ncdays):
                if v is not None and (not isinstance(v, int)
                                      or isinstance(v, bool) or v < 1):
                    raise GatewayError(
                        f"InvalidArgument: days must be a positive "
                        f"int in rule {rid!r}")
        self.io.execute(self._index_obj(bucket), "rgw_index",
                        "set_lc", json.dumps(rules).encode())

    def get_bucket_lifecycle(self, bucket: str) -> list[dict]:
        self._check_bucket(bucket)
        return json.loads(self.io.execute(
            self._index_obj(bucket), "rgw_index", "get_lc"))

    def delete_bucket_lifecycle(self, bucket: str) -> None:
        self._check_bucket(bucket)
        self.io.execute(self._index_obj(bucket), "rgw_index", "del_lc")

    def _list_all_entries(self, bucket: str, prefix: str) -> list[dict]:
        out, marker = [], ""
        while True:
            page = self.list_objects(bucket, prefix=prefix,
                                     marker=marker, limit=1000)
            out.extend(page["entries"])
            if not page.get("truncated"):
                return out
            marker = page["next_marker"]

    def lc_process(self, bucket: str | None = None) -> dict:
        """One lifecycle worker pass (upstream's RGWLC runs this on a
        schedule; here the driver/test calls it — same model as scrub).
        Applies Enabled rules against the gateway clock and returns
        {bucket: {expired: [keys], noncurrent_expired: [(key, vid)],
        markers_cleaned: [keys]}}."""
        buckets = [bucket] if bucket is not None else self.list_buckets()
        now = self._clock()
        report: dict = {}
        for b in buckets:
            rules = [r for r in self.get_bucket_lifecycle(b)
                     if r.get("status", "Enabled") == "Enabled"]
            if not rules:
                continue
            rep = {"expired": [], "noncurrent_expired": [],
                   "markers_cleaned": []}
            versioned = self._versioning(b) != "Off"
            for r in rules:
                prefix = r.get("prefix", "")
                days = r.get("expiration_days")
                if days is not None:
                    for ent in self._list_all_entries(b, prefix):
                        if now - ent["mtime"] >= days * self._LC_DAY:
                            # versioned: becomes a delete marker;
                            # unversioned: gone for real (S3 semantics)
                            self.delete_object(b, ent["key"])
                            rep["expired"].append(ent["key"])
                ncdays = r.get("noncurrent_days")
                if ncdays is not None and versioned:
                    vs = self.list_object_versions(b, prefix=prefix)
                    # versions arrive per key newest-first: a version
                    # became NONCURRENT when its successor was written,
                    # so its retention clock starts at the PREVIOUS
                    # (newer) entry's mtime — S3 guarantees
                    # NoncurrentDays of retention from succession, not
                    # from the version's own creation (ref: rgw_lc.cc
                    # effective_mtime of the next entry)
                    prev_by_key: dict[str, float] = {}
                    for v in vs["versions"]:
                        since = prev_by_key.get(v["key"])
                        prev_by_key[v["key"]] = v["mtime"]
                        if v.get("is_latest") or since is None:
                            continue
                        if now - since >= ncdays * self._LC_DAY:
                            self.delete_object(b, v["key"],
                                               version_id=v["vid"])
                            rep["noncurrent_expired"].append(
                                (v["key"], v["vid"]))
                if days is not None and versioned:
                    # expired-object-delete-marker cleanup, scoped to
                    # THIS rule's prefix (the cleanup is part of the
                    # Expiration action, not bucket-wide — ref: S3
                    # ExpiredObjectDeleteMarker): a key whose only
                    # remaining version is its latest delete marker
                    # serves nothing
                    by_key: dict[str, list] = {}
                    for v in self.list_object_versions(
                            b, prefix=prefix)["versions"]:
                        by_key.setdefault(v["key"], []).append(v)
                    for key, kvs in by_key.items():
                        if len(kvs) == 1 \
                                and kvs[0].get("delete_marker") \
                                and kvs[0].get("is_latest"):
                            self.delete_object(b, key,
                                               version_id=kvs[0]["vid"])
                            rep["markers_cleaned"].append(key)
            if any(rep.values()):
                report[b] = rep
        return report
