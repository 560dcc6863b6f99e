"""librbd-shaped block-image API: striped images, per-image snapshots,
and COW clone layering.

Rebuild of the reference's block-device surface (ref: src/librbd/ —
`rbd create/resize/remove`, Image::{read,write,size}; snapshots:
librbd snap_create/snap_rollback/snap_protect over SELF-MANAGED rados
snaps + per-op SnapContext, ref: src/librbd/Operations.cc,
src/osdc/Objecter snapc plumbing; layering: clone/copy-up/flatten,
ref: src/librbd/io/CopyupRequest.cc, src/cls/rbd clone/children
bookkeeping; python binding shape ref: src/pybind/rbd/rbd.pyx).

Design notes (framework-native, not a transliteration):

* An image IS striped rados objects plus a JSON header object. Image
  snapshots ride the pool's self-managed snap machinery: `snap_create`
  allocates a pool-wide snap id, and every later data write carries
  that id as its SnapContext (`snapc=`), so the OSD COW-preserves
  clones for THIS image's objects only — other images in the pool,
  whose writers name no snaps, are untouched. That is exactly how
  librbd gets per-image snapshots out of one shared pool.
* Clone layering does copy-up at stripe-piece granularity (the
  reference's unit is its rados object; ours is the striper's piece
  object): the invariant is "a piece object existing in the child
  makes the child authoritative for every extent that maps to it".
  Reads of missing pieces fall through to the parent AT ITS SNAP
  (recursively — grandparent chains work); the first write that
  touches a missing piece first materializes it from the parent
  (the CopyupRequest role), then applies the write.
* `diff_iterate` uses the OSD's metadata-only `snap_changed` (SnapSet
  + birth eras) per piece — the fast-diff/object-map role — instead
  of reading and comparing data.

Simplifications vs the reference, disclosed: flatten requires the
clone to have no snapshots of its own (upstream needs the deep-flatten
feature for that case); diff granularity is the stripe piece, not the
byte range; diff with `from_snap=None` reports the CHILD's allocated
extents only (parent-inherited data is the parent's diff).
"""

from __future__ import annotations

import json

from .rados import IoCtx, RadosStriper


class ImageHasSnapshots(ValueError):
    pass


class ImageBusy(ValueError):
    pass


_CHILDREN_OBJ = "rbd_children"    # ref: cls_rbd children directory


class RBD:
    """Image administration (the RBD() role)."""

    def __init__(self, ioctx: IoCtx, stripe_unit: int = 1 << 16,
                 stripe_count: int = 4, object_size: int = 1 << 22,
                 full_stripe_writes: bool = False):
        self.io = ioctx
        self._geom = (stripe_unit, stripe_count, object_size)
        # r20: block IO rides write_at (the r16 partial-stripe fast
        # path on EC pools) by default; True falls back to the
        # read-merge-write_full full-stripe path (the A/B baseline)
        self.full_stripe_writes = bool(full_stripe_writes)

    def _hdr(self, name: str) -> str:
        return f"rbd_header.{name}"

    def create(self, name: str, size: int) -> "Image":
        if size < 0:
            raise ValueError(f"size {size} < 0")
        if self._exists(name):
            raise FileExistsError(f"image {name!r} exists")
        self._save_hdr(name, {"v": 2, "size": size, "snaps": [],
                              "parent": None})
        return Image(self, name)

    # -- header codec (v1 = bare 8-byte size, pre-snapshot rounds) ----------

    def _load_hdr(self, name: str) -> dict:
        raw = self.io.read(self._hdr(name))
        if len(raw) == 8:      # legacy v1 header
            return {"v": 1, "size": int.from_bytes(raw, "little"),
                    "snaps": [], "parent": None}
        return json.loads(raw.decode())

    def _save_hdr(self, name: str, hdr: dict) -> None:
        self.io.write_full(self._hdr(name),
                           json.dumps(hdr, sort_keys=True).encode())

    def _exists(self, name: str) -> bool:
        try:
            self.io.read(self._hdr(name))
            return True
        except KeyError:
            return False

    def list(self) -> list[str]:
        pre = "rbd_header."
        return sorted(n[len(pre):] for n in self.io.list_objects()
                      if n.startswith(pre))

    def remove(self, name: str) -> None:
        hdr = self._load_hdr(name)   # raises KeyError if missing
        if hdr["snaps"]:
            raise ImageHasSnapshots(
                f"image {name!r} has {len(hdr['snaps'])} snapshot(s); "
                "remove them first (rbd: image has snapshots)")
        if hdr["parent"]:
            self._deregister_child(hdr["parent"], name)
        st = RadosStriper(self.io, *self._geom,
                          full_stripe_writes=self.full_stripe_writes)
        try:
            st.remove(f"rbd_data.{name}")
        except KeyError:
            pass  # never written
        self.io.remove(self._hdr(name))

    # -- layering: clone + children directory -------------------------------

    def clone(self, parent_name: str, snap_name: str,
              child_name: str) -> "Image":
        """COW clone of parent@snap (ref: librbd clone; requires the
        snap protected, as upstream — protection is what guarantees
        the parent data a child depends on cannot be trimmed)."""
        phdr = self._load_hdr(parent_name)
        snap = _find_snap(phdr, snap_name)
        if not snap["protected"]:
            raise ValueError(
                f"snap {parent_name!r}@{snap_name!r} is not protected "
                "(rbd: parent snapshot must be protected)")
        if self._exists(child_name):
            raise FileExistsError(f"image {child_name!r} exists")
        self._save_hdr(child_name, {
            "v": 2, "size": snap["size"], "snaps": [],
            "parent": {"image": parent_name, "snap_id": snap["id"],
                       "snap_name": snap_name,
                       "overlap": snap["size"]}})
        self._register_child(
            {"image": parent_name, "snap_id": snap["id"]}, child_name)
        return Image(self, child_name)

    def _children_dir(self) -> dict:
        try:
            return json.loads(self.io.read(_CHILDREN_OBJ).decode())
        except KeyError:
            return {}

    @staticmethod
    def _child_key(parent: dict) -> str:
        return f"{parent['image']}@{parent['snap_id']}"

    def _register_child(self, parent: dict, child: str) -> None:
        d = self._children_dir()
        kids = d.setdefault(self._child_key(parent), [])
        if child not in kids:
            kids.append(child)
        self.io.write_full(_CHILDREN_OBJ,
                           json.dumps(d, sort_keys=True).encode())

    def _deregister_child(self, parent: dict, child: str) -> None:
        d = self._children_dir()
        key = self._child_key(parent)
        kids = [c for c in d.get(key, []) if c != child]
        if kids:
            d[key] = kids
        else:
            d.pop(key, None)
        self.io.write_full(_CHILDREN_OBJ,
                           json.dumps(d, sort_keys=True).encode())

    def list_children(self, parent_name: str,
                      snap_name: str) -> list[str]:
        phdr = self._load_hdr(parent_name)
        snap = _find_snap(phdr, snap_name)
        return sorted(self._children_dir().get(
            self._child_key({"image": parent_name,
                             "snap_id": snap["id"]}), []))


def _find_snap(hdr: dict, snap_name: str) -> dict:
    for s in hdr["snaps"]:
        if s["name"] == snap_name:
            return s
    raise KeyError(f"no snap {snap_name!r}")


def _snap_by_id(hdr: dict, sid: int) -> dict:
    for s in hdr["snaps"]:
        if s["id"] == sid:
            return s
    raise KeyError(f"no snap id {sid}")


class Image:
    """One open image (the Image() role): bounds-checked random-access
    byte I/O, snapshots, and clone-aware reads/writes."""

    def __init__(self, rbd: RBD, name: str):
        self.rbd = rbd
        self.name = name
        su, sc, osz = rbd._geom
        self._striper = RadosStriper(
            rbd.io, stripe_unit=su, stripe_count=sc, object_size=osz,
            full_stripe_writes=rbd.full_stripe_writes)
        self._soid = f"rbd_data.{name}"
        self._at_snap: int | None = None   # set_snap read mode
        self._pcache: dict[tuple, "Image"] = {}   # parent-at-snap
        self._hdr()  # existence check

    # -- header state -------------------------------------------------------

    def _hdr(self) -> dict:
        return self.rbd._load_hdr(self.name)

    def _save(self, hdr: dict) -> None:
        self.rbd._save_hdr(self.name, hdr)

    def _snapc(self, hdr: dict | None = None) -> int:
        """Newest image snap id = the SnapContext every data write of
        this image carries (0: no snaps, writes preserve nothing)."""
        snaps = (hdr or self._hdr())["snaps"]
        return max((s["id"] for s in snaps), default=0)

    def size(self) -> int:
        hdr = self._hdr()
        if self._at_snap is not None:
            return _snap_by_id(hdr, self._at_snap)["size"]
        return hdr["size"]

    def parent_info(self) -> tuple[str, str, int] | None:
        """(parent image, parent snap name, overlap) or None."""
        p = self._hdr()["parent"]
        return (p["image"], p["snap_name"], p["overlap"]) if p else None

    def resize(self, new_size: int) -> None:
        """Grow or shrink. A shrink really discards the bytes past the
        boundary (striper truncate zeroes them), so a later re-grow
        reads zeros there — the block-device contract."""
        self._check_writable()
        if new_size < 0:
            raise ValueError(f"size {new_size} < 0")
        hdr = self._hdr()
        if new_size < hdr["size"]:
            # a shrink's zero-writes can CREATE a previously missing
            # boundary piece; for a clone that piece must be copied up
            # first or its sub-extents below new_size would become
            # child-authoritative zeros over parent data
            if hdr["parent"]:
                self._copy_up(hdr, new_size, hdr["size"] - new_size)
            try:
                self._striper.truncate(self._soid, new_size,
                                       snapc=self._snapc(hdr))
            except KeyError:
                pass  # nothing ever written; nothing to discard
            # a shrink below the parent overlap permanently narrows it
            # (ref: librbd shrink trims parent_overlap). Snapshots keep
            # their own recorded overlap (per-snap, as librbd does).
            if hdr["parent"] and new_size < hdr["parent"]["overlap"]:
                hdr["parent"]["overlap"] = new_size
        hdr["size"] = new_size
        self._save(hdr)

    def _check_writable(self) -> None:
        if self._at_snap is not None:
            raise ValueError("image is set to a snapshot (read-only); "
                             "set_snap(None) first")

    # -- snapshots ----------------------------------------------------------

    def set_snap(self, snap_name: str | None) -> None:
        """Route reads to the image's state at the snap (librbd
        set_snap); None returns to the live head."""
        if snap_name is None:
            self._at_snap = None
            return
        self._at_snap = _find_snap(self._hdr(), snap_name)["id"]

    def snap_create(self, snap_name: str) -> int:
        self._check_writable()
        hdr = self._hdr()
        if any(s["name"] == snap_name for s in hdr["snaps"]):
            raise FileExistsError(f"snap {snap_name!r} exists")
        sid = self.rbd.io.selfmanaged_snap_create()
        snap = {"id": sid, "name": snap_name,
                "size": hdr["size"], "protected": False}
        if hdr["parent"]:
            # each snap records the parent overlap AS OF the snap
            # (librbd keeps per-snapshot parent info): a later shrink
            # narrows only the head's overlap, not history's
            snap["overlap"] = min(hdr["parent"]["overlap"],
                                  hdr["size"])
        hdr["snaps"].append(snap)
        self._save(hdr)
        return sid

    def snap_list(self) -> list[dict]:
        return [dict(s) for s in self._hdr()["snaps"]]

    def snap_protect(self, snap_name: str) -> None:
        hdr = self._hdr()
        _find_snap(hdr, snap_name)["protected"] = True
        self._save(hdr)

    def snap_unprotect(self, snap_name: str) -> None:
        hdr = self._hdr()
        snap = _find_snap(hdr, snap_name)
        kids = self.rbd.list_children(self.name, snap_name)
        if kids:
            raise ImageBusy(
                f"snap {snap_name!r} has {len(kids)} clone child(ren) "
                f"({', '.join(kids)}); flatten or remove them first")
        snap["protected"] = False
        self._save(hdr)

    def snap_is_protected(self, snap_name: str) -> bool:
        return bool(_find_snap(self._hdr(), snap_name)["protected"])

    def snap_remove(self, snap_name: str) -> None:
        hdr = self._hdr()
        snap = _find_snap(hdr, snap_name)
        if snap["protected"]:
            raise ImageBusy(f"snap {snap_name!r} is protected")
        self.rbd.io.selfmanaged_snap_remove(snap["id"])
        hdr["snaps"] = [s for s in hdr["snaps"]
                        if s["id"] != snap["id"]]
        self._save(hdr)

    def snap_rollback(self, snap_name: str) -> None:
        """Write the snap's state back onto the head (librbd
        snap_rollback). The rollback writes themselves carry the
        newest snapc, so the pre-rollback head stays readable at any
        newer snap."""
        self._check_writable()
        hdr = self._hdr()
        snap = _find_snap(hdr, snap_name)
        # capture the snap's full state (clone-aware, at-snap)
        prev = self._at_snap
        self._at_snap = snap["id"]
        try:
            data = self.read(0, snap["size"])
        finally:
            self._at_snap = prev
        self.resize(snap["size"])
        if data:
            self.write(0, data)

    # -- data path ----------------------------------------------------------

    def write(self, offset: int, data: bytes) -> int:
        self._check_writable()
        hdr = self._hdr()
        end = offset + len(data)
        if offset < 0 or end > hdr["size"]:
            raise ValueError(
                f"write [{offset}, {end}) outside image size "
                f"{hdr['size']}")
        if not data:
            return 0
        if hdr["parent"]:
            self._copy_up(hdr, offset, len(data))
        self._striper.write(self._soid, data, offset=offset,
                            snapc=self._snapc(hdr))
        return len(data)

    def read(self, offset: int, length: int) -> bytes:
        hdr = self._hdr()
        size = _snap_by_id(hdr, self._at_snap)["size"] \
            if self._at_snap is not None else hdr["size"]
        if offset < 0 or offset > size:
            raise ValueError(f"read offset {offset} outside size {size}")
        length = min(length, size - offset)
        if length <= 0:
            return b""
        if hdr["parent"]:
            return self._clone_read(hdr, offset, length)
        got = self._plain_read(offset, length)
        # sparse regions (never written) read as zeros, like a block dev
        return got.ljust(length, b"\x00")

    def _plain_read(self, offset: int, length: int) -> bytes:
        try:
            return self._striper.read(self._soid, length=length,
                                      offset=offset, snap=self._at_snap)
        except KeyError:
            return b""  # nothing written yet

    # -- clone layering internals -------------------------------------------

    def _piece_exists(self, q: int) -> bool:
        name = self._striper._obj(self._soid, q)
        try:
            if self._at_snap is None:
                self.rbd.io.stat(name)
            else:
                self.rbd.io.read(name, length=0, snap=self._at_snap)
            return True
        except KeyError:
            return False

    def _parent_image(self, hdr: dict) -> "Image":
        """Open (and cache) the parent at its clone snap. Caching is
        safe: a parent-at-snap is immutable while children exist (the
        snap is protected, and flatten refuses on an image that still
        has snaps), so one existence check per child Image suffices."""
        p = hdr["parent"]
        key = (p["image"], p["snap_id"])
        parent = self._pcache.get(key)
        if parent is None:
            parent = Image(self.rbd, p["image"])
            parent._at_snap = p["snap_id"]
            self._pcache[key] = parent
        return parent

    def _clone_read(self, hdr: dict, offset: int, length: int) -> bytes:
        """Per-piece: child piece exists -> child is authoritative;
        missing piece -> parent-at-snap serves extents inside the
        overlap, zeros beyond (ref: librbd io::ImageReadRequest parent
        fall-through)."""
        p = hdr["parent"]
        parent = self._parent_image(hdr)
        if self._at_snap is not None:
            # at-snap reads honor the overlap recorded AT that snap,
            # not the head's (which later shrinks may have narrowed)
            snap = _snap_by_id(hdr, self._at_snap)
            overlap = snap.get("overlap", p["overlap"])
        else:
            overlap = p["overlap"]
        out = bytearray(length)
        exists: dict[int, bool] = {}
        # coalesce consecutive same-source extents into ranged reads:
        # a striped read otherwise issues one parent/child call PER
        # stripe unit, each re-reading headers down the parent chain
        runs: list[list] = []       # [from_child, start, len]
        for q, ooff, lpos, ln in self._striper._extents(offset, length):
            if q not in exists:
                exists[q] = self._piece_exists(q)
            src = exists[q]
            if not src and lpos >= overlap:
                continue            # missing piece past overlap: zeros
            take = ln if src else min(ln, overlap - lpos)
            if runs and runs[-1][0] == src \
                    and runs[-1][1] + runs[-1][2] == lpos:
                runs[-1][2] += take
            else:
                runs.append([src, lpos, take])
        for from_child, start, ln in runs:
            got = self._plain_read(start, ln) if from_child \
                else parent.read(start, ln)
            out[start - offset:start - offset + len(got)] = got
        return bytes(out)

    def _piece_extents(self, q: int, upto: int):
        return self._striper.piece_extents(q, upto)

    def _copy_up(self, hdr: dict, offset: int, length: int) -> None:
        """Materialize every missing piece the write will touch from
        the parent (ref: librbd io::CopyupRequest): after this, the
        child is authoritative for those pieces and the plain striper
        write may proceed."""
        p = hdr["parent"]
        overlap = min(p["overlap"], hdr["size"])
        parent = self._parent_image(hdr)
        snapc = self._snapc(hdr)
        touched = {q for q, _, _, _ in
                   self._striper._extents(offset, length)}
        for q in sorted(touched):
            if self._piece_exists(q):
                continue
            for loff, ln in self._piece_extents(q, overlap):
                got = parent.read(loff, ln)
                self._striper.write(self._soid, got, offset=loff,
                                    snapc=snapc)

    def flatten(self) -> None:
        """Copy every still-inherited piece up from the parent, then
        sever the parent link (librbd flatten). Requires the clone to
        have no snapshots of its own (upstream needs the deep-flatten
        feature for that; disclosed simplification)."""
        self._check_writable()
        hdr = self._hdr()
        p = hdr["parent"]
        if p is None:
            return
        if hdr["snaps"]:
            raise ImageHasSnapshots(
                "flatten with own snapshots needs deep-flatten; "
                "remove the clone's snapshots first")
        overlap = min(p["overlap"], hdr["size"])
        if overlap:
            self._copy_up(hdr, 0, overlap)
        hdr["parent"] = None
        self._save(hdr)
        self.rbd._deregister_child(p, self.name)

    # -- incremental export/import (rbd export-diff / import-diff) ----------

    def export_diff(self, from_snap: str | None = None) -> bytes:
        """Serialize the extents that changed since `from_snap` (None:
        every allocated extent — a full export-diff) into a versioned
        blob import_diff applies (ref: src/tools/rbd/action/
        ExportDiff.cc stream format role: header + sized extent
        records)."""
        from ..utils.encoding import Encoder
        if self._at_snap is not None:
            # diff_iterate pins the head view; mixing at-snap reads
            # with head-derived runs would serialize an inconsistent
            # stream (or fault past the snap size)
            raise ValueError("export_diff operates on the live head; "
                             "set_snap(None) first")
        hdr = self._hdr()
        if hdr["parent"] and from_snap is None:
            # a FULL export of a clone must include parent-inherited
            # data (diff_iterate reports child-materialized pieces
            # only): union the allocated pieces of EVERY layer down
            # the parent chain (clipped to each overlap) instead of
            # serializing the whole image — sparse clones stay sparse
            # in the stream
            runs = self._exported_runs(hdr, hdr["size"])
        else:
            runs = self.diff_iterate(from_snap=from_snap)
        e = Encoder().start(1, 1)
        e.string(from_snap or "")
        e.u64(hdr["size"])
        e.u32(len(runs))
        for off, ln in runs:
            e.u64(off).blob(self.read(off, ln))
        return e.finish().bytes()

    def _exported_runs(self, hdr: dict, upto: int) -> list[tuple]:
        """Merged (offset, len) runs where data may exist for this
        image view: own allocated pieces plus, for clones, the parent
        chain's allocated pieces clipped to the overlap."""
        runs: list[tuple[int, int]] = []
        if upto:
            pieces = {q for q, _, _, _ in
                      self._striper._extents(0, upto)}
            for q in sorted(pieces):
                if self._piece_exists(q):
                    runs.extend(self._piece_extents(q, upto))
        p = hdr["parent"]
        if p is not None:
            parent = self._parent_image(hdr)
            ov = min(p["overlap"], upto)
            runs.extend(parent._exported_runs(parent._hdr(), ov))
        runs.sort()
        merged: list[tuple[int, int]] = []
        for off, ln in runs:
            if merged and off <= merged[-1][0] + merged[-1][1]:
                end = max(merged[-1][0] + merged[-1][1], off + ln)
                merged[-1] = (merged[-1][0], end - merged[-1][0])
            else:
                merged.append((off, ln))
        return merged

    def import_diff(self, blob: bytes) -> int:
        """Apply an export-diff stream: the from-snap (when the stream
        names one) must exist on THIS image — the same continuity
        check `rbd import-diff` enforces, or an incremental chain
        applied out of order silently corrupts. Returns bytes
        written."""
        from ..utils.encoding import Decoder
        self._check_writable()
        d = Decoder(blob)
        d.start(1)
        from_snap = d.string()
        size = d.u64()
        n = d.u32()
        if from_snap:
            _find_snap(self._hdr(), from_snap)   # KeyError: broken chain
        if self.size() != size:
            self.resize(size)
        written = 0
        for _ in range(n):
            off = d.u64()
            data = d.blob()
            self.write(off, bytes(data))
            written += len(data)
        d.finish()
        return written

    # -- diff ---------------------------------------------------------------

    def diff_iterate(self, from_snap: str | None = None) -> list[tuple]:
        """Changed extents since `from_snap` (None: allocated extents),
        at stripe-piece granularity, as (offset, length) sorted merged
        runs. Uses the OSD's metadata-only snap_changed — the
        fast-diff role; no data is read. Always computed against the
        live HEAD — a set_snap read mode is ignored for the duration
        (mixing at-snap existence probes with head sizing would yield
        an extent set that is neither view)."""
        hdr = self._hdr()
        size = hdr["size"]
        if not size:
            return []
        from_sid = _find_snap(hdr, from_snap)["id"] if from_snap \
            else None
        changed: list[tuple[int, int]] = []
        pieces = {q for q, _, _, _ in self._striper._extents(0, size)}
        prev_at_snap, self._at_snap = self._at_snap, None
        try:
            for q in sorted(pieces):
                name = self._striper._obj(self._soid, q)
                if from_sid is not None:
                    # snap_changed returns False for never-written
                    # names; it raises only for an UNKNOWN snap id — a
                    # real header/pool desync that must surface, not
                    # be swallowed as "empty diff"
                    dirty = self.rbd.io.snap_changed(name, from_sid)
                else:
                    dirty = self._piece_exists(q)
                if dirty:
                    changed.extend(self._piece_extents(q, size))
        finally:
            self._at_snap = prev_at_snap
        changed.sort()
        # merge adjacent runs for a compact diff
        merged: list[tuple[int, int]] = []
        for off, ln in changed:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((off, ln))
        return merged
