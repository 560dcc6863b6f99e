"""Object classes — server-side methods executed at the object.

Rebuild of the reference's cls plugin system (ref: src/osd/
ClassHandler.cc loading cls_*.so; objclass API src/objclass/
objclass.h — cls_cxx_read/write/map_get_val/...; dispatched from
PrimaryLogPG::do_osd_ops CEPH_OSD_OP_CALL). A class method runs AT the
object's primary with transactional access to the object's data and a
KV plane, so read-modify-write logic executes without a client round
trip per step.

TPU-first framing: classes are pure-Python callables registered in a
table (the dlopen role is already covered by native/'s EC plugin ABI);
the DATA they touch still moves through the normal client path, so EC
encode fan-out, snapshots' COW, and PG logging all apply to cls
writes exactly as to client writes.

Built-ins mirror the reference's most-used classes:
* `lock`   — advisory object locks (ref: src/cls/lock/cls_lock.cc):
  lock/unlock/break_lock/get_info, exclusive or shared, owner+cookie.
* `refcount` — get/put/read a reference count; the object removes
  itself when the count drops to zero (ref: src/cls/refcount).
* `version` — bump/read a monotonically increasing object version
  (ref: src/cls/version).

Method I/O is bytes->bytes with JSON envelopes (auditable in tests;
the reference uses its own encodings — an implementation detail, not
behavior)."""

from __future__ import annotations

import json

_CLS: dict[tuple[str, str], object] = {}


def register_cls(cls: str, method: str):
    """Decorator: register fn(handle, input_bytes) -> bytes."""
    def deco(fn):
        key = (cls, method)
        if key in _CLS and _CLS[key] is not fn:
            raise ValueError(f"cls method {cls}.{method} already "
                             f"registered")
        _CLS[key] = fn
        return fn
    return deco


class ClsHandle:
    """What a class method sees: the one object it was invoked on
    (cls_cxx_* surface). Data ops route through the cluster's client
    path; `kv` is the object's key-value plane (cls map ops)."""

    def __init__(self, cluster, name: str):
        self._c = cluster
        self.name = name

    def exists(self) -> bool:
        ps = self._c.locate(self.name)
        return self.name in self._c.pgs[ps].object_sizes

    def stat(self) -> int:
        ps = self._c.locate(self.name)
        return self._c.pgs[ps].stat_object(self.name)

    def read(self) -> bytes:
        return bytes(self._c.read(self.name))

    def write_full(self, data: bytes) -> None:
        self._c.write({self.name: data})

    def remove(self) -> None:
        self._c.remove(self.name)
        self._c.obj_kv.pop(self.name, None)

    @property
    def kv(self) -> dict:
        return self._c.obj_kv.setdefault(self.name, {})


class ClsError(RuntimeError):
    """A class method refused the operation (the -EBUSY/-ENOENT style
    error return of the reference's cls methods)."""


def cls_call(cluster, name: str, cls: str, method: str,
             inp: bytes = b"") -> bytes:
    fn = _CLS.get((cls, method))
    if fn is None:
        raise KeyError(f"no object class method {cls}.{method}")
    return fn(ClsHandle(cluster, name), inp)


# -- built-in: advisory locks (cls_lock) -------------------------------------

def _lock_state(h: ClsHandle) -> dict:
    return h.kv.setdefault("lock", {"type": None, "holders": {}})


@register_cls("lock", "lock")
def _lock_lock(h: ClsHandle, inp: bytes) -> bytes:
    req = json.loads(inp or b"{}")
    owner = req.get("owner", "")
    ltype = req.get("type", "exclusive")
    if ltype not in ("exclusive", "shared"):
        raise ClsError(f"bad lock type {ltype!r}")
    st = _lock_state(h)
    if st["holders"]:
        if owner in st["holders"]:
            if ltype != st["type"]:
                # upgrades/downgrades are not silent no-ops — the
                # caller would believe it holds the new type (the
                # reference cls_lock returns -EBUSY here too)
                raise ClsError("EBUSY: lock upgrade not supported")
            return b"{}"             # re-entrant for the same owner
        if st["type"] == "exclusive" or ltype == "exclusive":
            raise ClsError("EBUSY: lock held")
    st["type"] = ltype
    st["holders"][owner] = {"since": "held"}
    return b"{}"


@register_cls("lock", "unlock")
def _lock_unlock(h: ClsHandle, inp: bytes) -> bytes:
    owner = json.loads(inp or b"{}").get("owner", "")
    st = _lock_state(h)
    if owner not in st["holders"]:
        raise ClsError("ENOENT: not a lock holder")
    del st["holders"][owner]
    if not st["holders"]:
        st["type"] = None
    return b"{}"


@register_cls("lock", "break_lock")
def _lock_break(h: ClsHandle, inp: bytes) -> bytes:
    """Forcibly evict another client's lock (the recovery path an
    operator uses when a lock holder died)."""
    owner = json.loads(inp or b"{}").get("owner", "")
    st = _lock_state(h)
    st["holders"].pop(owner, None)
    if not st["holders"]:
        st["type"] = None
    return b"{}"


@register_cls("lock", "get_info")
def _lock_info(h: ClsHandle, inp: bytes) -> bytes:
    st = _lock_state(h)
    return json.dumps({"type": st["type"],
                       "holders": sorted(st["holders"])}).encode()


# -- built-in: refcount ------------------------------------------------------

@register_cls("refcount", "get")
def _ref_get(h: ClsHandle, inp: bytes) -> bytes:
    h.kv["refs"] = h.kv.get("refs", 0) + 1
    return json.dumps({"refs": h.kv["refs"]}).encode()


@register_cls("refcount", "put")
def _ref_put(h: ClsHandle, inp: bytes) -> bytes:
    refs = h.kv.get("refs", 0) - 1
    if refs < 0:
        raise ClsError("EINVAL: refcount underflow")
    h.kv["refs"] = refs
    if refs == 0:
        h.remove()                   # last ref drops the object
    return json.dumps({"refs": refs}).encode()


@register_cls("refcount", "read")
def _ref_read(h: ClsHandle, inp: bytes) -> bytes:
    return json.dumps({"refs": h.kv.get("refs", 0)}).encode()


# -- built-in: version -------------------------------------------------------

@register_cls("version", "bump")
def _ver_bump(h: ClsHandle, inp: bytes) -> bytes:
    h.kv["ver"] = h.kv.get("ver", 0) + 1
    return json.dumps({"ver": h.kv["ver"]}).encode()


@register_cls("version", "read")
def _ver_read(h: ClsHandle, inp: bytes) -> bytes:
    return json.dumps({"ver": h.kv.get("ver", 0)}).encode()
