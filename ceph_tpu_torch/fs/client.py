"""CephFS-lite — the POSIX-shaped file layer over rados.

Rebuild of the reference's filesystem data/metadata split (ref:
src/mds/ — CInode/CDentry/MDCache; dirfrag omap objects holding
dentries with EMBEDDED inodes, src/mds/CDir.cc; file DATA addressed
by inode number through the file layout into plain rados objects,
src/osd + libcephfs read/write path; client ops shape ref:
src/client/Client.cc mkdir/create/unlink/rename/readdir).

Mapping onto this framework:

* DIRECTORIES are objects (`.fs.dir.{ino}`) whose dentries live in
  the object-class KV plane and mutate atomically AT the object via
  the `fs_dir` class below — exactly the dirfrag-omap role. Each
  dentry embeds its inode (type, size, mtime, ino), the reference's
  primary-dentry embedding.
* FILE DATA is striped at `.fs.data.{ino}` through the RadosStriper —
  the file-layout striping of {ino}.{index} objects, client-side.
* INODE NUMBERS come from an allocator object (`.fs.meta`) bumped via
  cls (the InoTable role).
* The MDS ITSELF — a metadata-caching server process — collapses to
  these object-class methods: metadata mutations are already atomic
  at the dirfrag object, so the sim needs no extra daemon between
  client and OSD.
* FILE CAPABILITIES (ref: src/mds/Locker.cc issue/revoke; client
  caps Fr/Fw in src/client/Client.cc) map onto the cls `lock` class
  on a per-inode caps anchor (`.fs.caps.{ino}`): `open(path, "r")`
  acquires a SHARED lock (the Fr cap), `open(path, "w"/"rw")` an
  EXCLUSIVE one (Fw); conflicting opens fail with FsBusy instead of
  the reference's asynchronous revoke (fail-fast-lite), bare
  write/truncate/unlink refuse while another client holds caps, and
  `break_caps` is the operator eviction path for a dead holder
  (`ceph tell mds.N client evict` role). Multiple-active-MDS stays
  out of scope.

Everything rides librados/striper: EC fan-out, snapshots' COW,
recovery, scrub, and PG splits apply to file data and dirfrags with
no special cases."""

from __future__ import annotations

import json
import posixpath

from ..client.rados import IoCtx, RadosStriper
from ..osd.objclass import ClsError, ClsHandle, register_cls

ROOT_INO = 1
_META_OBJ = ".fs.meta"


class FsError(Exception):
    pass


class NotADir(FsError, NotADirectoryError):
    pass


class IsADir(FsError, IsADirectoryError):
    pass


class NotEmpty(FsError, OSError):
    pass


class FsBusy(FsError, OSError):
    """A conflicting capability is held by another client."""


# -- dirfrag object class (CDir dentry ops) ----------------------------------

@register_cls("fs_dir", "link")
def _dir_link(h: ClsHandle, inp: bytes) -> bytes:
    req = json.loads(inp)
    dents = h.kv.setdefault("dentries", {})
    if req["name"] in dents and not req.get("replace", False):
        raise ClsError(f"EEXIST: {req['name']}")
    dents[req["name"]] = req["ent"]
    # the dentry count rides back so the client can decide to split
    # this frag (CDir::should_split checks size at the MDS the same
    # way — on the structure that just grew)
    return json.dumps({"count": len(dents)}).encode()


@register_cls("fs_dir", "unlink")
def _dir_unlink(h: ClsHandle, inp: bytes) -> bytes:
    name = json.loads(inp)["name"]
    dents = h.kv.setdefault("dentries", {})
    if name not in dents:
        raise ClsError(f"ENOENT: {name}")
    ent = dents.pop(name)
    return json.dumps({"ent": ent, "count": len(dents)}).encode()


@register_cls("fs_dir", "get_bits")
def _dir_get_bits(h: ClsHandle, inp: bytes) -> bytes:
    return json.dumps({"bits": h.kv.get("frag_bits", 0)}).encode()


@register_cls("fs_dir", "set_bits")
def _dir_set_bits(h: ClsHandle, inp: bytes) -> bytes:
    h.kv["frag_bits"] = json.loads(inp)["bits"]
    return b"{}"


@register_cls("fs_dir", "load")
def _dir_load(h: ClsHandle, inp: bytes) -> bytes:
    """Replace this frag's whole dentry table in one op (the bulk
    move of a split/merge; frag_bits in the same KV is untouched)."""
    h.kv["dentries"] = json.loads(inp)
    return b"{}"


@register_cls("fs_dir", "set_quota")
def _dir_set_quota(h: ClsHandle, inp: bytes) -> bytes:
    q = json.loads(inp)
    if q:
        h.kv["quota"] = q
    else:
        h.kv.pop("quota", None)
    return b"{}"


@register_cls("fs_dir", "get_quota")
def _dir_get_quota(h: ClsHandle, inp: bytes) -> bytes:
    return json.dumps(h.kv.get("quota", {})).encode()


@register_cls("fs_dir", "clear")
def _dir_clear(h: ClsHandle, inp: bytes) -> bytes:
    h.kv.pop("dentries", None)
    return b"{}"


@register_cls("fs_dir", "lookup")
def _dir_lookup(h: ClsHandle, inp: bytes) -> bytes:
    name = json.loads(inp)["name"]
    ent = h.kv.get("dentries", {}).get(name)
    if ent is None:
        raise ClsError(f"ENOENT: {name}")
    return json.dumps(ent).encode()


@register_cls("fs_dir", "route")
def _dir_route(h: ClsHandle, inp: bytes) -> bytes:
    """Combined bits+lookup on the BASE dirfrag: an unfragmented dir
    (the common case) answers the dentry in ONE round-trip; a
    fragmented one returns its bits so the client re-aims at the frag
    — the MDS client piggybacks the fragtree on traversal the same
    way instead of refetching it per hop."""
    name = json.loads(inp)["name"]
    bits = h.kv.get("frag_bits", 0)
    if bits:
        return json.dumps({"bits": bits}).encode()
    ent = h.kv.get("dentries", {}).get(name)
    return json.dumps({"bits": 0, "found": ent is not None,
                       "ent": ent}).encode()


@register_cls("fs_dir", "list")
def _dir_list(h: ClsHandle, inp: bytes) -> bytes:
    return json.dumps(h.kv.get("dentries", {})).encode()


@register_cls("fs_dir", "update")
def _dir_update(h: ClsHandle, inp: bytes) -> bytes:
    req = json.loads(inp)
    ent = h.kv.get("dentries", {}).get(req["name"])
    if ent is None:
        raise ClsError(f"ENOENT: {req['name']}")
    ent.update(req["fields"])
    return json.dumps(ent).encode()


@register_cls("fs_meta", "alloc_ino")
def _meta_alloc(h: ClsHandle, inp: bytes) -> bytes:
    nxt = h.kv.get("next_ino", ROOT_INO + 1)
    h.kv["next_ino"] = nxt + 1
    return json.dumps({"ino": nxt}).encode()


class FsClient:
    """A mounted filesystem handle (the libcephfs Client role).

    `name` identifies this mount as a capability owner (the client
    session id the MDS would track); two FsClients with different
    names contend for caps. Each open handle is its own locker
    ('{name}#{seq}'), so shared handles of one mount coexist and
    close independently; exclusive conflicts — including same-mount
    upgrades — fail fast with FsBusy."""

    STRIPE_UNIT = 1 << 16
    STRIPE_COUNT = 4
    OBJECT_SIZE = 1 << 20

    def __init__(self, ioctx: IoCtx, name: str = "fsclient",
                 frag_split_threshold: int = 128,
                 frag_merge_threshold: int | None = None,
                 max_frag_bits: int = 6,
                 full_stripe_writes: bool = False):
        self.io = ioctx
        self.name = name
        # directory fragmentation knobs (ref: mds_bal_split_size /
        # mds_bal_merge_size + fragtree_t). Simplification disclosed:
        # fragmentation is UNIFORM per directory (all frags at one
        # bit-depth), where the reference's fragtree can split frags
        # unevenly.
        self.frag_split_threshold = frag_split_threshold
        self.frag_merge_threshold = (frag_split_threshold // 8
                                     if frag_merge_threshold is None
                                     else frag_merge_threshold)
        self.max_frag_bits = max_frag_bits
        # r20: file data rides write_at (partial-stripe fast path on
        # EC pools) unless the full-stripe fallback knob is set
        self._striper = RadosStriper(
            ioctx, stripe_unit=self.STRIPE_UNIT,
            stripe_count=self.STRIPE_COUNT,
            object_size=self.OBJECT_SIZE,
            full_stripe_writes=full_stripe_writes)
        # mkfs-on-first-mount: root dirfrag + ino allocator
        try:
            self.io.stat(_META_OBJ)
        except KeyError:
            self.io.write_full(_META_OBJ, b"fsmeta")
            self.io.write_full(self._dir_obj(ROOT_INO), b"dirfrag")

    # -- naming --------------------------------------------------------------

    @staticmethod
    def _dir_obj(ino: int) -> str:
        return f".fs.dir.{ino}"

    @staticmethod
    def _data_obj(ino: int) -> str:
        return f".fs.data.{ino}"

    @staticmethod
    def _caps_obj(ino: int) -> str:
        # the per-inode capability anchor: one UNSTRIPED object whose
        # cls-lock KV is the caps ledger (the Locker's per-inode state)
        return f".fs.caps.{ino}"

    def _clock(self) -> float:
        from ..client.rados import sim_clock
        return sim_clock(self.io)

    def _alloc_ino(self) -> int:
        out = self.io.execute(_META_OBJ, "fs_meta", "alloc_ino")
        return json.loads(out)["ino"]

    # -- directory fragmentation (CDir::split/merge, fragtree_t) -------------

    def _frag_obj(self, ino: int, frag: int, bits: int) -> str:
        return f"{self._dir_obj(ino)}.f{frag:x}b{bits}"

    def _dir_bits(self, ino: int) -> int:
        raw = self.io.execute(self._dir_obj(ino), "fs_dir", "get_bits")
        return json.loads(raw)["bits"]

    @staticmethod
    def _frag_of(name: str, bits: int) -> int:
        import zlib
        return zlib.crc32(name.encode()) & ((1 << bits) - 1) \
            if bits else 0

    def _dentry_obj(self, ino: int, name: str,
                    bits: int | None = None) -> str:
        """The object holding `name`'s dentry under the dir's current
        fragmentation (bits 0 = the base dirfrag itself)."""
        if bits is None:
            bits = self._dir_bits(ino)
        if bits == 0:
            return self._dir_obj(ino)
        return self._frag_obj(ino, self._frag_of(name, bits), bits)

    def _frag_objs(self, ino: int, bits: int) -> list[str]:
        if bits == 0:
            return [self._dir_obj(ino)]
        return [self._frag_obj(ino, f, bits) for f in range(1 << bits)]

    def _list_all(self, ino: int, bits: int | None = None) -> dict:
        """Merged dentries across every frag (CDir::get_dentries over
        the fragtree)."""
        if bits is None:
            bits = self._dir_bits(ino)
        out: dict = {}
        for obj in self._frag_objs(ino, bits):
            try:
                out.update(json.loads(
                    self.io.execute(obj, "fs_dir", "list")))
            except (ClsError, KeyError):
                pass    # frag object missing: empty frag
        return out

    def _link(self, ino: int, name: str, ent: dict,
              replace: bool = False) -> None:
        obj = self._dentry_obj(ino, name)
        raw = self.io.execute(obj, "fs_dir", "link",
                              json.dumps({"name": name, "ent": ent,
                                          "replace": replace}).encode())
        if json.loads(raw)["count"] > self.frag_split_threshold:
            self._split_dir(ino)

    def _unlink(self, ino: int, name: str) -> None:
        obj = self._dentry_obj(ino, name)
        raw = self.io.execute(obj, "fs_dir", "unlink",
                              json.dumps({"name": name}).encode())
        # this frag's remaining count is a LOWER bound on the dir
        # total: above the merge threshold the full 2^bits listing in
        # _maybe_merge can't fire and is skipped at zero extra I/O
        if json.loads(raw)["count"] <= self.frag_merge_threshold:
            self._maybe_merge(ino)

    def _reload_level(self, ino: int, bits: int, dents: dict) -> None:
        """Write `dents` out as fragmentation level `bits` (bulk load
        per frag), without touching frag_bits."""
        groups: dict[int, dict] = {}
        for name, ent in dents.items():
            groups.setdefault(self._frag_of(name, bits), {})[name] = ent
        for f, obj in enumerate(self._frag_objs(ino, bits)):
            if bits:
                self.io.write_full(obj, b"dirfrag")
            self.io.execute(obj, "fs_dir", "load",
                            json.dumps(groups.get(f, {})).encode())

    def _split_dir(self, ino: int) -> None:
        """One level deeper (CDir::split). Crash ordering: new frags
        are fully materialized BEFORE frag_bits flips (readers keep
        the old layout until the single-object commit point), then the
        old level is cleared; a crash in between leaves unreachable
        stale copies that the next split/merge rewrites."""
        bits = self._dir_bits(ino)
        if bits >= self.max_frag_bits:
            return
        dents = self._list_all(ino, bits)
        self._reload_level(ino, bits + 1, dents)
        self.io.execute(self._dir_obj(ino), "fs_dir", "set_bits",
                        json.dumps({"bits": bits + 1}).encode())
        self._drop_level(ino, bits)

    def _maybe_merge(self, ino: int) -> None:
        """Shallower — as many levels as the shrink warrants — when
        the whole dir dropped below the merge threshold (CDir::merge;
        upstream's mds_bal_merge_size)."""
        while True:
            bits = self._dir_bits(ino)
            if bits == 0:
                return
            dents = self._list_all(ino, bits)
            if len(dents) > self.frag_merge_threshold:
                return
            self._reload_level(ino, bits - 1, dents)
            self.io.execute(self._dir_obj(ino), "fs_dir", "set_bits",
                            json.dumps({"bits": bits - 1}).encode())
            self._drop_level(ino, bits)

    def _drop_level(self, ino: int, bits: int) -> None:
        if bits == 0:
            self.io.execute(self._dir_obj(ino), "fs_dir", "clear")
            return
        for obj in self._frag_objs(ino, bits):
            try:
                self.io.remove(obj)
            except KeyError:
                pass

    def frag_info(self, path: str) -> dict:
        """Observability: the dir's fragmentation state (`ceph tell
        mds dirfrag ls` role)."""
        ent = self._walk(self._split(path))
        if ent["type"] != "dir":
            raise NotADir(path)
        bits = self._dir_bits(ent["ino"])
        per = {}
        for obj in self._frag_objs(ent["ino"], bits):
            try:
                per[obj] = len(json.loads(
                    self.io.execute(obj, "fs_dir", "list")))
            except (ClsError, KeyError):
                per[obj] = 0
        return {"bits": bits, "frags": 1 << bits if bits else 1,
                "dentries": sum(per.values()), "per_frag": per}

    # -- directory quotas (ref: the vxattrs ceph.quota.max_bytes /
    #    ceph.quota.max_files, enforced by Client::check_quota_condition
    #    against the quota realm's rstats) --------------------------------

    class QuotaExceeded(FsError, OSError):
        pass

    def set_quota(self, path: str, max_bytes: int | None = None,
                  max_files: int | None = None) -> None:
        """`setfattr -n ceph.quota.*`: attach (or clear, with both
        None) a quota to a directory."""
        ent = self._walk(self._split(path))
        if ent["type"] != "dir":
            raise NotADir(path)
        q = {}
        for name, v in (("max_bytes", max_bytes),
                        ("max_files", max_files)):
            if v is not None:
                if not isinstance(v, int) or isinstance(v, bool) \
                        or v < 1:
                    raise FsError(f"quota {name} must be a positive "
                                  f"int, got {v!r}")
                q[name] = v
        self.io.execute(self._dir_obj(ent["ino"]), "fs_dir",
                        "set_quota", json.dumps(q).encode())

    def get_quota(self, path: str) -> dict:
        ent = self._walk(self._split(path))
        if ent["type"] != "dir":
            raise NotADir(path)
        return json.loads(self.io.execute(
            self._dir_obj(ent["ino"]), "fs_dir", "get_quota"))

    def du(self, path: str) -> dict:
        """{bytes, files} under a directory (recursive; the rstats
        role, computed on demand — disclosed simplification vs the
        MDS's incrementally-maintained rstats)."""
        ent = self._walk(self._split(path))
        if ent["type"] != "dir":
            raise NotADir(path)
        return self._du_ino(ent["ino"])

    def _du_ino(self, ino: int) -> dict:
        total = {"bytes": 0, "files": 0}
        for name, ent in self._list_all(ino).items():
            if ent["type"] == "dir":
                sub = self._du_ino(ent["ino"])
                total["bytes"] += sub["bytes"]
                # a directory IS an entry (rentries counts subdirs
                # toward max_files in the reference's rstats)
                total["files"] += sub["files"] + 1
            else:
                total["bytes"] += ent["size"]
                total["files"] += 1
        return total

    def _check_quota(self, chain: list[int], add_bytes: int = 0,
                     add_files: int = 0) -> None:
        """Check every quota realm on the (pre-collected) ancestor
        chain; any quota the growth would breach refuses with EDQUOT
        (Client::check_quota_condition walks realms upward the same
        way). The chain comes from the op's own _walk — no second
        path resolution."""
        if add_bytes <= 0 and add_files <= 0:
            return
        for ino in chain:
            q = json.loads(self.io.execute(
                self._dir_obj(ino), "fs_dir", "get_quota"))
            if not q:
                continue
            use = self._du_ino(ino)
            if "max_bytes" in q \
                    and use["bytes"] + add_bytes > q["max_bytes"]:
                raise self.QuotaExceeded(
                    f"EDQUOT: {use['bytes']} + {add_bytes} bytes "
                    f"exceeds max_bytes={q['max_bytes']}")
            if "max_files" in q \
                    and use["files"] + add_files > q["max_files"]:
                raise self.QuotaExceeded(
                    f"EDQUOT: {use['files']} + {add_files} files "
                    f"exceeds max_files={q['max_files']}")

    # -- path walk (MDCache::path_traverse) ----------------------------------

    @staticmethod
    def _split(path: str) -> list[str]:
        path = posixpath.normpath("/" + path)
        return [p for p in path.split("/") if p]

    def _walk(self, parts: list[str],
              chain: list[int] | None = None) -> dict:
        """Resolve to the dentry of the LAST part; root pseudo-dentry
        for []. Raises FileNotFoundError / NotADir on the way. When
        `chain` is given, the inos of every DIRECTORY on the path
        (root included, the target too if it is a dir) are appended —
        the quota realm chain, collected for free during the walk."""
        cur = {"ino": ROOT_INO, "type": "dir", "size": 0, "mtime": 0.0}
        if chain is not None:
            chain.append(ROOT_INO)
        for i, name in enumerate(parts):
            if cur["type"] != "dir":
                raise NotADir("/" + "/".join(parts[:i]))
            try:
                r = json.loads(self.io.execute(
                    self._dir_obj(cur["ino"]), "fs_dir", "route",
                    json.dumps({"name": name}).encode()))
                if r["bits"] == 0:
                    if not r["found"]:
                        raise ClsError("ENOENT")
                    cur = r["ent"]
                else:
                    raw = self.io.execute(
                        self._dentry_obj(cur["ino"], name,
                                         bits=r["bits"]),
                        "fs_dir", "lookup",
                        json.dumps({"name": name}).encode())
                    cur = json.loads(raw)
            except (ClsError, KeyError):
                raise FileNotFoundError(
                    "/" + "/".join(parts[:i + 1])) from None
            if chain is not None and cur["type"] == "dir":
                chain.append(cur["ino"])
        return cur

    def _parent_and_name(self, path: str,
                         chain: list[int] | None = None
                         ) -> tuple[dict, str]:
        parts = self._split(path)
        if not parts:
            raise FsError("operation on /")
        parent = self._walk(parts[:-1], chain=chain)
        if parent["type"] != "dir":
            raise NotADir(posixpath.dirname("/" + "/".join(parts)))
        return parent, parts[-1]

    # -- metadata ops --------------------------------------------------------

    def mkdir(self, path: str) -> None:
        chain: list[int] = []
        parent, name = self._parent_and_name(path, chain=chain)
        self._check_quota(chain, add_files=1)
        ino = self._alloc_ino()
        self.io.write_full(self._dir_obj(ino), b"dirfrag")
        ent = {"ino": ino, "type": "dir", "size": 0,
               "mtime": self._clock()}
        self._link(parent["ino"], name, ent)

    def create(self, path: str, data: bytes = b"") -> None:
        """create + write in one call (the O_CREAT|O_WRONLY shape)."""
        chain: list[int] = []
        parent, name = self._parent_and_name(path, chain=chain)
        self._check_quota(chain, add_files=1)
        ino = self._alloc_ino()
        ent = {"ino": ino, "type": "file", "size": 0,
               "mtime": self._clock()}
        self._link(parent["ino"], name, ent)
        if data:
            self.write(path, data)

    def stat(self, path: str) -> dict:
        return dict(self._walk(self._split(path)))

    def readdir(self, path: str) -> dict[str, dict]:
        ent = self._walk(self._split(path))
        if ent["type"] != "dir":
            raise NotADir(path)
        return self._list_all(ent["ino"])

    def unlink(self, path: str) -> None:
        parent, name = self._parent_and_name(path)
        ent = self._walk(self._split(path))
        if ent["type"] == "dir":
            raise IsADir(path)
        self._check_caps(ent["ino"], write=True, what=f"unlink {path}")
        self._unlink(parent["ino"], name)
        try:
            self._striper.remove(self._data_obj(ent["ino"]))
        except KeyError:
            pass                     # never written
        try:
            self.io.remove(self._caps_obj(ent["ino"]))
        except KeyError:
            pass                     # never opened

    def rmdir(self, path: str) -> None:
        parent, name = self._parent_and_name(path)
        ent = self._walk(self._split(path))
        if ent["type"] != "dir":
            raise NotADir(path)
        if self.readdir(path):
            raise NotEmpty(path)
        bits = self._dir_bits(ent["ino"])
        self._unlink(parent["ino"], name)
        if bits:
            self._drop_level(ent["ino"], bits)
        self.io.remove(self._dir_obj(ent["ino"]))

    def rename(self, src: str, dst: str) -> None:
        """Atomic-at-the-dentries rename: unlink src, link dst with
        the SAME inode — data never moves (the MDS rename property).
        An existing dst file is replaced (POSIX); a dst dir must not
        exist."""
        schain: list[int] = []
        sparent, sname = self._parent_and_name(src, chain=schain)
        dchain: list[int] = []
        dparent, dname = self._parent_and_name(dst, chain=dchain)
        ent = self._walk(self._split(src))
        if sparent["ino"] == dparent["ino"] and sname == dname:
            # POSIX: same-path rename is a no-op. Without this the
            # dst link rewrites the dentry and the src unlink then
            # REMOVES it — the file vanishes and its data orphans.
            return
        # ONE dst resolution serves both the quota credit and the
        # replace/EEXIST checks below
        try:
            dent = self._walk(self._split(dst))
        except FileNotFoundError:
            dent = None
        if sparent["ino"] != dparent["ino"]:
            # a CROSS-directory move must satisfy the destination's
            # quota realms (the reference checks quota on cross-realm
            # rename) — a subtree brings its whole recursive usage
            if ent["type"] == "dir":
                use = self._du_ino(ent["ino"])
                mv_bytes, mv_files = use["bytes"], use["files"] + 1
            else:
                mv_bytes, mv_files = ent["size"], 1
            # a replace-rename frees the dst file it overwrites: the
            # NET growth is what quota enforces (POSIX replace into an
            # exactly-full realm must not spuriously EDQUOT)
            if dent is not None and dent["type"] == "file":
                mv_bytes -= dent["size"]
                mv_files -= 1
            # ancestors COMMON to src and dst see no net change from
            # the move — charging them would spuriously EDQUOT an
            # exactly-full shared realm
            common = set(schain)
            self._check_quota([i for i in dchain if i not in common],
                              add_bytes=mv_bytes, add_files=mv_files)
        if ent["type"] == "file":
            # a held capability pins the NAME too: renaming a file
            # out from under an open handle would strand its caps
            # (the MDS takes the dentry lock before rename the same
            # way)
            self._check_caps(ent["ino"], write=True,
                             what=f"rename {src}")
        if dent is not None:
            if dent["type"] == "dir":
                raise FsError(f"EEXIST: {dst} is a directory")
            if ent["type"] == "dir":
                # replacing an existing FILE with a directory is
                # ENOTDIR in POSIX (rename(2)); silently swapping the
                # types would strand the file's data object
                raise NotADir(dst)
            self._check_caps(dent["ino"], write=True,
                             what=f"rename over {dst}")
            old_ino = dent["ino"]
        else:
            old_ino = None
        self._link(dparent["ino"], dname, ent, replace=True)
        self._unlink(sparent["ino"], sname)
        if old_ino is not None and old_ino != ent["ino"]:
            for obj, rm in ((self._data_obj(old_ino),
                             self._striper.remove),
                            (self._caps_obj(old_ino), self.io.remove)):
                try:
                    rm(obj)
                except KeyError:
                    pass

    # -- data ops ------------------------------------------------------------

    # -- capabilities (Locker/caps-lite) -------------------------------------

    @staticmethod
    def _holder_mount(holder: str) -> str:
        """Holder strings are '{mount}#{handle-seq}' (the owner+cookie
        pairing of cls_lock in the reference — the cookie makes each
        handle its own locker, so closing one of a mount's two handles
        releases only its own cap)."""
        return holder.split("#", 1)[0]

    def _caps_state(self, ino: int) -> dict:
        caps = self._caps_obj(ino)
        try:
            self.io.stat(caps)   # get_info on a missing object would
        except KeyError:         # materialize its KV as a side effect
            return {"type": None, "holders": []}
        try:
            raw = self.io.execute(caps, "lock", "get_info")
        except (KeyError, ClsError):
            return {"type": None, "holders": []}
        return json.loads(raw)

    def _check_caps(self, ino: int, write: bool, what: str) -> None:
        """Fail-fast conflict check for capability-less ops: an op by
        this client is refused while ANOTHER mount holds conflicting
        caps (the reference would instead revoke asynchronously)."""
        st = self._caps_state(ino)
        others = [h for h in st["holders"]
                  if self._holder_mount(h) != self.name]
        if not others:
            return
        if write or st["type"] == "exclusive":
            raise FsBusy(f"{what}: caps held by {others} "
                         f"({st['type']})")

    def open(self, path: str, mode: str = "r") -> "FsFile":
        """Acquire caps and return a handle: "r" -> shared (Fr),
        "w"/"rw" -> exclusive (Fw, creating the file if absent).
        A conflicting holder raises FsBusy — the fail-fast analog of
        the MDS delaying the open until revoke completes."""
        if mode not in ("r", "w", "rw"):
            raise ValueError(f"bad mode {mode!r}")
        writable = "w" in mode
        try:
            ent = self._walk(self._split(path))
        except FileNotFoundError:
            if not writable:
                raise
            self.create(path)
            ent = self._walk(self._split(path))
        if ent["type"] != "file":
            raise IsADir(path)
        caps = self._caps_obj(ent["ino"])
        try:
            self.io.stat(caps)
        except KeyError:
            self.io.write_full(caps, b"caps")
        # one locker PER HANDLE (owner#seq — the owner+cookie pairing):
        # closing one of this mount's two read handles must release
        # only its own cap, not the sibling's
        self._handle_seq = getattr(self, "_handle_seq", 0) + 1
        holder = f"{self.name}#{self._handle_seq}"
        try:
            self.io.execute(caps, "lock", "lock", json.dumps(
                {"owner": holder,
                 "type": "exclusive" if writable else "shared"}
            ).encode())
        except ClsError as e:
            raise FsBusy(f"open {path} ({mode}): {e}") from None
        return FsFile(self, path, ent["ino"], mode, holder)

    def caps_info(self, path: str) -> dict:
        """{'type', 'holders'} for the path's inode (session ls role)."""
        ent = self._walk(self._split(path))
        return self._caps_state(ent["ino"])

    def break_caps(self, path: str, holder: str) -> None:
        """Operator eviction of a dead holder's caps (ref: cls_lock
        break_lock; `ceph tell mds.N client evict` role). `holder` is
        a full '{mount}#{seq}' string as listed by caps_info; a bare
        mount name evicts every one of that mount's handles."""
        ent = self._walk(self._split(path))
        victims = [h for h in self._caps_state(ent["ino"])["holders"]
                   if h == holder or self._holder_mount(h) == holder]
        for v in victims:
            try:
                self.io.execute(self._caps_obj(ent["ino"]), "lock",
                                "break_lock",
                                json.dumps({"owner": v}).encode())
            except (KeyError, ClsError):
                pass                 # no caps object / already gone

    def _release_caps(self, ino: int, holder: str) -> None:
        try:
            self.io.execute(self._caps_obj(ino), "lock", "unlock",
                            json.dumps({"owner": holder}).encode())
        except (KeyError, ClsError):
            pass                     # already broken/unlinked

    @staticmethod
    def _expect(ent: dict, path: str, expect_ino: int | None) -> None:
        """Stale-handle guard, enforced on the SAME walked entry the
        I/O uses (no second resolve, no check-then-act window)."""
        if expect_ino is not None and ent["ino"] != expect_ino:
            raise FsError(
                f"{path}: stale handle (inode {expect_ino} -> "
                f"{ent['ino']}; the name was replaced underneath)")

    def write(self, path: str, data: bytes, offset: int = 0,
              _expect_ino: int | None = None) -> None:
        chain: list[int] = []
        parent, name = self._parent_and_name(path, chain=chain)
        ent = self._walk(self._split(path))
        if ent["type"] != "file":
            raise IsADir(path)
        self._expect(ent, path, _expect_ino)
        self._check_caps(ent["ino"], write=True, what=f"write {path}")
        self._check_quota(chain,
                          add_bytes=max(0, offset + len(data)
                                        - ent["size"]))
        self._striper.write(self._data_obj(ent["ino"]), bytes(data),
                            offset=offset)
        new_size = max(ent["size"], offset + len(data))
        self.io.execute(self._dentry_obj(parent["ino"], name),
                        "fs_dir", "update",
                        json.dumps({"name": name,
                                    "fields": {"size": new_size,
                                               "mtime": self._clock()}
                                    }).encode())

    def read(self, path: str, length: int | None = None,
             offset: int = 0, _expect_ino: int | None = None) -> bytes:
        ent = self._walk(self._split(path))
        if ent["type"] != "file":
            raise IsADir(path)
        self._expect(ent, path, _expect_ino)
        self._check_caps(ent["ino"], write=False, what=f"read {path}")
        if ent["size"] == 0:
            return b""
        if length is None:
            length = max(0, ent["size"] - offset)
        return self._striper.read(self._data_obj(ent["ino"]),
                                  length=length, offset=offset)

    def truncate(self, path: str, size: int,
                 _expect_ino: int | None = None) -> None:
        chain: list[int] = []
        parent, name = self._parent_and_name(path, chain=chain)
        ent = self._walk(self._split(path))
        if ent["type"] != "file":
            raise IsADir(path)
        self._expect(ent, path, _expect_ino)
        self._check_caps(ent["ino"], write=True,
                         what=f"truncate {path}")
        self._check_quota(chain,
                          add_bytes=max(0, size - ent["size"]))
        if ent["size"] == 0 and size > 0:
            # sparse grow of a never-written file: materialize zeros
            self._striper.write(self._data_obj(ent["ino"]), b"\x00")
        if ent["size"] > 0 or size > 0:
            self._striper.truncate(self._data_obj(ent["ino"]), size)
        self.io.execute(self._dentry_obj(parent["ino"], name),
                        "fs_dir", "update",
                        json.dumps({"name": name,
                                    "fields": {"size": size,
                                               "mtime": self._clock()}
                                    }).encode())


class FsFile:
    """An open file handle holding capabilities until close() — the
    Fh + caps pairing of the reference client. Read requires Fr
    (any mode), write/truncate require Fw (mode with "w"); close
    releases exactly this handle's cap (holder = mount#seq), never a
    sibling handle's. Context-manager friendly.

    Handles are PATH-pinned (a lite deviation from the reference's
    ino-addressed Fh): each I/O's single path resolve must still name
    the inode the caps were granted on (enforced on the same walked
    entry the I/O uses) — a rename or unlink+recreate underneath
    turns the handle stale and raises FsError instead of silently
    writing a DIFFERENT inode under the old inode's caps (which would
    let two exclusive writers coexist). Caps checks in rename/unlink
    make that impossible across mounts; the guard catches the same
    mount doing it to itself."""

    def __init__(self, client: FsClient, path: str, ino: int,
                 mode: str, holder: str):
        self.client, self.path, self.ino = client, path, ino
        self.mode, self.holder = mode, holder
        self._open = True

    def _alive(self) -> None:
        if not self._open:
            raise ValueError(f"I/O on closed file {self.path}")

    def read(self, length: int | None = None, offset: int = 0) -> bytes:
        self._alive()
        return self.client.read(self.path, length=length, offset=offset,
                                _expect_ino=self.ino)

    def write(self, data: bytes, offset: int = 0) -> None:
        self._alive()
        if "w" not in self.mode:
            raise PermissionError(
                f"{self.path}: opened read-only (no Fw cap)")
        self.client.write(self.path, data, offset=offset,
                          _expect_ino=self.ino)

    def truncate(self, size: int) -> None:
        self._alive()
        if "w" not in self.mode:
            raise PermissionError(
                f"{self.path}: opened read-only (no Fw cap)")
        self.client.truncate(self.path, size, _expect_ino=self.ino)

    def close(self) -> None:
        if self._open:
            self._open = False
            self.client._release_caps(self.ino, self.holder)

    def __enter__(self) -> "FsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
