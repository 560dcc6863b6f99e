"""cephx-shaped ticket authentication.

Rebuild of the reference's auth subsystem behavior (ref: src/auth/
cephx — CephxKeyServer rotating service secrets, CephxServiceHandler
challenge/response, CephxClientHandler, CephxAuthorizeHandler;
mon side: src/mon/AuthMonitor.cc; caps grammar: src/mon/MonCap.cc,
src/osd/OSDCap.cc). The protocol SHAPE is kept — Kerberos-style
tickets so OSDs never hold client secrets and the monitor is not on
the data path — while the primitives are this framework's existing
ones (HMAC-SHA256 proofs, AES-256-GCM sealed ticket blobs, the same
AEAD the ProtocolV2 secure mode uses), not a transliteration of
cephx's AES-CBC constructions.

Flow (mirrors CEPHX_GET_AUTH_SESSION_KEY / CEPHX_GET_PRINCIPAL_SESSION_KEY):

1. client -> mon   : hello(entity, client_challenge)
2. mon    -> client: server_challenge
3. client -> mon   : proof = HMAC(entity_secret, sc || cc)
4. mon    -> client: auth ticket = {enc(entity_secret, session_key),
                     blob sealed under the AUTH service secret}
   — possession of the entity secret is needed to read session_key;
   the blob is opaque to the client.
5. client -> mon   : authorizer(session_key) + wanted services
   mon    -> client: per-service tickets {enc(session_key,
                     svc_session_key), blob under that service's
                     ROTATING secret}
6. client -> osd   : authorizer = (blob, nonce, HMAC(svc_session_key,
                     nonce)); the OSD unseals the blob with its
                     distributed rotating secret, checks expiry+MAC,
                     learns (entity, caps, svc_session_key) and
                     replies HMAC(svc_session_key, nonce || "server")
                     — mutual auth (the CephxAuthorizeHandler
                     challenge round).

Rotating secrets: per-service list of (secret_id, key, expiry); the
newest seals new tickets, the previous two still open blobs (ref:
KeyServerData::rotating_secrets keeps current/prev/next), so daemons
that refresh on a timer never race a rotation.
"""

from __future__ import annotations

import hmac
import json
import os
import struct
import time as _time
from hashlib import sha256


class AuthError(Exception):
    pass


class NeedChallenge(AuthError):
    """The daemon demands a fresh server challenge be bound into the
    authorizer MAC before it will accept it (ref: the cephx server
    challenge added for CVE-2018-1128 — without it a captured
    authorizer replays)."""

    def __init__(self, challenge_hex: str):
        super().__init__("server challenge required")
        self.challenge = challenge_hex


def _hmac(key: bytes, *parts: bytes) -> bytes:
    h = hmac.new(key, digestmod=sha256)
    for p in parts:
        h.update(struct.pack("<I", len(p)))
        h.update(p)
    return h.digest()


def _seal(key: bytes, payload: dict) -> bytes:
    from .aead import AEAD
    nonce = os.urandom(12)
    plain = json.dumps(payload, sort_keys=True).encode()
    return nonce + AEAD(key).encrypt(nonce, plain, b"cephx-tkt")


def _unseal(key: bytes, blob: bytes) -> dict:
    from .aead import AEAD, InvalidTag
    if len(blob) < 12 + 16:
        raise AuthError("ticket blob truncated")
    try:
        plain = AEAD(key).decrypt(blob[:12], blob[12:], b"cephx-tkt")
    except InvalidTag:
        raise AuthError("ticket blob failed authentication (tampered "
                        "or wrong secret)")
    return json.loads(plain.decode())


def _b(x: bytes) -> str:
    return x.hex()


def _ub(s: str) -> bytes:
    return bytes.fromhex(s)


# -- capabilities ------------------------------------------------------------

class Caps:
    """Simplified MonCap/OSDCap grammar: comma-separated grants of
    `allow <perms>[ pool=<name>]`, perms in {r, w, x} combos or `*`.
    A grant with pool= applies only to that pool; without, to all."""

    def __init__(self, spec: str):
        self.grants: list[tuple[set, str | None]] = []
        spec = spec.strip()
        if not spec:
            return
        for part in spec.split(","):
            toks = part.split()
            if not toks or toks[0] != "allow":
                raise AuthError(f"bad cap grant {part!r}")
            perms: set[str] = set()
            pool = None
            for t in toks[1:]:
                if t.startswith("pool="):
                    pool = t[5:]
                elif t == "*":
                    perms |= {"r", "w", "x"}
                elif set(t) <= {"r", "w", "x"}:
                    perms |= set(t)
                else:
                    raise AuthError(f"bad cap token {t!r} in {part!r}")
            if not perms:
                raise AuthError(f"empty perms in cap grant {part!r}")
            self.grants.append((perms, pool))

    def allows(self, op: str, pool: str | None = None) -> bool:
        for perms, gpool in self.grants:
            if op in perms and (gpool is None or gpool == pool):
                return True
        return False


# -- key server (monitor-resident) -------------------------------------------

ROTATING_KEEP = 3          # current + two predecessors stay valid
DEFAULT_TTL = 3600.0       # ticket / rotating-secret lifetime


class KeyServer:
    """Entity secrets + per-service rotating secrets (ref:
    src/auth/cephx/CephxKeyServer.cc KeyServerData)."""

    def __init__(self, ttl: float = DEFAULT_TTL, now_fn=_time.time):
        self.ttl = ttl
        self.now = now_fn
        self.entities: dict[str, dict] = {}
        # service -> newest-first [(secret_id, key, expires)]
        self.rotating: dict[str, list[tuple[int, bytes, float]]] = {}
        self._next_id = 1

    def create_entity(self, name: str,
                      caps: dict[str, str] | None = None) -> bytes:
        secret = os.urandom(32)
        self.entities[name] = {"secret": secret, "caps": caps or {}}
        return secret

    def entity_secret(self, name: str) -> bytes:
        try:
            return self.entities[name]["secret"]
        except KeyError:
            raise AuthError(f"unknown entity {name!r}")

    def rotate(self, service: str) -> int:
        """Mint a new rotating secret for `service`; the previous
        ROTATING_KEEP-1 stay openable."""
        sid = self._next_id
        self._next_id += 1
        lst = self.rotating.setdefault(service, [])
        lst.insert(0, (sid, os.urandom(32),
                       self.now() + self.ttl * ROTATING_KEEP))
        del lst[ROTATING_KEEP:]
        return sid

    def current_secret(self, service: str) -> tuple[int, bytes]:
        lst = self.rotating.get(service)
        if not lst:
            self.rotate(service)
            lst = self.rotating[service]
        sid, key, exp = lst[0]
        # auto-rotate once the newest secret has served a full ttl
        # (ref: the monitor's rotating-secret timer): without this a
        # long-lived realm seals new tickets under an aging secret
        # until EVERYTHING expires at once and auth bricks
        minted = exp - self.ttl * ROTATING_KEEP
        if self.now() >= minted + self.ttl:
            self.rotate(service)
            sid, key, exp = self.rotating[service][0]
        return sid, key

    def secret_by_id(self, service: str, sid: int) -> bytes:
        for s, key, exp in self.rotating.get(service, []):
            if s == sid:
                if self.now() > exp:
                    raise AuthError(f"{service} secret {sid} expired")
                return key
        raise AuthError(f"{service} secret {sid} rotated out")

    def export_rotating(self, service: str) -> list[tuple[int, str, float]]:
        """What the monitor pushes to daemons of `service` (ref:
        MAuth rotating_secrets distribution)."""
        self.current_secret(service)   # ensure one exists
        return [(sid, _b(key), exp)
                for sid, key, exp in self.rotating[service]]


class AuthService:
    """Monitor-side handler (ref: CephxServiceHandler +
    AuthMonitor)."""

    MAX_PENDING = 256
    MAX_PENDING_PER_ENTITY = 8
    PENDING_TTL = 60.0

    def __init__(self, ks: KeyServer):
        self.ks = ks
        # (entity, client_challenge) -> (server challenge, issued-at):
        # keyed by the PAIR so concurrent logins of one entity (two
        # clients sharing client.admin) can't clobber each other's
        # outstanding challenge. Eviction is per-entity + by age — a
        # spammer repeating hello() for one known entity name only
        # evicts its OWN challenges, never another entity's in-flight
        # login (the r4 advisor's bounded-DoS finding)
        self._pending: dict[tuple[str, str], tuple[bytes, float]] = {}

    def _expire_pending(self, now: float) -> None:
        dead = [k for k, (_, ts) in self._pending.items()
                if now - ts > self.PENDING_TTL]
        for k in dead:
            del self._pending[k]

    # step 2
    def hello(self, entity: str, client_challenge: bytes) -> bytes:
        self.ks.entity_secret(entity)          # unknown entity -> err
        now = self.ks.now()
        self._expire_pending(now)
        mine = [k for k in self._pending if k[0] == entity]
        while len(mine) >= self.MAX_PENDING_PER_ENTITY:
            self._pending.pop(mine.pop(0), None)
        if len(self._pending) >= self.MAX_PENDING:
            # global pressure: evict the oldest challenge of the
            # entity holding the MOST pending entries (under attack
            # that is an attacker name at its per-entity cap; a
            # legitimate login holds 1). Hard-rejecting here would
            # itself be a login DoS for uninvolved entities.
            by_entity: dict[str, list] = {}
            for k in self._pending:
                by_entity.setdefault(k[0], []).append(k)
            heaviest = max(by_entity.values(), key=len)
            self._pending.pop(heaviest[0], None)
        sc = os.urandom(16)
        self._pending[(entity, client_challenge.hex())] = (sc, now)
        return sc

    # steps 3-4
    def authenticate(self, entity: str, client_challenge: bytes,
                     proof: bytes) -> dict:
        secret = self.ks.entity_secret(entity)
        entry = self._pending.pop(
            (entity, client_challenge.hex()), None)  # single-use
        if entry is None:
            raise AuthError("no outstanding challenge (replay?)")
        sc, issued = entry
        if self.ks.now() - issued > self.PENDING_TTL:
            raise AuthError("challenge expired")
        want = _hmac(secret, sc, client_challenge)
        if not hmac.compare_digest(want, proof):
            raise AuthError(f"bad proof for {entity!r}")
        session_key = os.urandom(32)
        expires = self.ks.now() + self.ks.ttl
        sid, auth_secret = self.ks.current_secret("auth")
        blob = _seal(auth_secret, {
            "entity": entity, "session_key": _b(session_key),
            "expires": expires,
            "caps": self.ks.entities[entity]["caps"]})
        return {
            # only the entity-secret holder can read the session key
            "enc_session_key": _b(_seal(secret, {
                "session_key": _b(session_key), "expires": expires})),
            "ticket": {"secret_id": sid, "blob": _b(blob)},
        }

    # step 5
    def get_service_tickets(self, ticket: dict, nonce: bytes,
                            mac: bytes, services: list[str]) -> dict:
        auth_secret = self.ks.secret_by_id("auth", ticket["secret_id"])
        t = _unseal(auth_secret, _ub(ticket["blob"]))
        if self.ks.now() > t["expires"]:
            raise AuthError("auth ticket expired")
        session_key = _ub(t["session_key"])
        if not hmac.compare_digest(_hmac(session_key, nonce), mac):
            raise AuthError("bad authorizer on ticket request")
        out = {}
        for svc in services:
            svc_key = os.urandom(32)
            expires = self.ks.now() + self.ks.ttl
            sid, rot = self.ks.current_secret(svc)
            blob = _seal(rot, {
                "entity": t["entity"], "session_key": _b(svc_key),
                "expires": expires,
                "caps": t["caps"]})
            out[svc] = {
                "enc_session_key": _b(_seal(session_key, {
                    "session_key": _b(svc_key), "expires": expires})),
                "ticket": {"secret_id": sid, "blob": _b(blob)},
            }
        return out


class ClientAuth:
    """Client-side driver (ref: CephxClientHandler). `auth` is the
    AuthService (or any transport proxying to one)."""

    def __init__(self, auth: AuthService, entity: str, secret: bytes,
                 now_fn=_time.time):
        import threading
        self.auth = auth
        self.entity = entity
        self.secret = secret
        self.now = now_fn
        self.session_key: bytes | None = None
        self._auth_ticket: dict | None = None
        self._svc: dict[str, dict] = {}   # service -> {key, expires, ticket}
        # one ClientAuth is shared by a daemon's dispatch threads AND
        # its background ticket prewarm. Two locks, two jobs:
        # _lock guards STATE only (never held across network I/O), so
        # authorizer_with_key's cached fast path can't stall behind a
        # monitor hunt; _io_lock serializes the refresh I/O itself
        # (login + ticket fetch) so concurrent refreshers don't
        # stampede the monitors. Ordering: _io_lock may take _lock,
        # never the reverse.
        self._lock = threading.RLock()
        self._io_lock = threading.Lock()
        # declared ticket-lifecycle counters ("cephx" logger): a daemon
        # nests them in its perf dump; single-flight-wait accounting
        # (refreshes deferred because one was already running) lives
        # at the daemon, which owns that gate
        from ..utils.perf_counters import PerfCountersBuilder
        self.perf = (PerfCountersBuilder("cephx")
                     .add_u64_counter("logins",
                                      "hello/authenticate rounds run")
                     .add_u64_counter("ticket_fetches",
                                      "service-ticket fetch rounds")
                     .add_u64_counter("ticket_relogins",
                                      "fetch rounds that re-logged in "
                                      "(auth ticket aged/rotated out)")
                     .add_time_avg("fetch_time",
                                   "fetch_tickets wall time incl. "
                                   "monitor hunt")
                     .create_perf_counters())

    def login(self) -> None:
        with self._io_lock:
            self._login_io()

    def _login_io(self) -> None:
        """Caller holds _io_lock. Network rounds WITHOUT _lock; the
        session state installs atomically at the end."""
        # one retry when the challenge went missing between hello and
        # authenticate (the answering monitor died in between, or an
        # overloaded auth service evicted it) — a fresh hello gets a
        # fresh challenge; a WRONG-SECRET failure stays terminal
        for attempt in range(2):
            cc = os.urandom(16)
            sc = self.auth.hello(self.entity, cc)
            proof = _hmac(self.secret, sc, cc)
            try:
                got = self.auth.authenticate(self.entity, cc, proof)
            except AuthError as e:
                if "challenge" in str(e) and attempt == 0:
                    continue
                raise
            break
        sk = _unseal(self.secret, _ub(got["enc_session_key"]))
        self.perf.inc("logins")
        with self._lock:
            self.session_key = _ub(sk["session_key"])
            self._auth_ticket = got["ticket"]

    def fetch_tickets(self, services: list[str]) -> None:
        t0 = _time.perf_counter()
        with self._io_lock:
            self.perf.inc("ticket_fetches")
            with self._lock:
                need_login = self.session_key is None
            if need_login:
                self._login_io()
            for attempt in range(2):
                with self._lock:
                    ticket = self._auth_ticket
                    skey = self.session_key
                nonce = os.urandom(16)
                try:
                    got = self.auth.get_service_tickets(
                        ticket, nonce, _hmac(skey, nonce), services)
                    break
                except AuthError as e:
                    # the AUTH ticket itself aged out (expired, or its
                    # sealing secret rotated out): re-login under the
                    # entity secret and retry — the long-lived-client
                    # path; a genuine refusal stays terminal
                    if attempt == 0 and ("expired" in str(e)
                                         or "rotated out" in str(e)):
                        self.perf.inc("ticket_relogins")
                        self._login_io()
                        continue
                    raise
            # unseal with the session key that REQUESTED the tickets
            fresh = {}
            for svc, entry in got.items():
                sk = _unseal(skey, _ub(entry["enc_session_key"]))
                fresh[svc] = {"key": _ub(sk["session_key"]),
                              "expires": sk["expires"],
                              "ticket": entry["ticket"]}
            with self._lock:
                self._svc.update(fresh)
        self.perf.tinc("fetch_time", _time.perf_counter() - t0)

    def has_ticket(self, service: str) -> bool:
        """Is a cached, unexpired `service` ticket present? Zero I/O:
        lets dispatch-path callers FAIL FAST on a cold cache instead
        of hunting monitors while holding their daemon lock — the
        monitor's reply can be head-of-line-blocked behind undelivered
        frames on the very connection whose reader waits for that
        lock (the boot map-storm deadlock)."""
        with self._lock:
            ent = self._svc.get(service)
            return ent is not None and self.now() <= ent["expires"] - 1.0

    def authorizer_for(self, service: str,
                       server_challenge: str | None = None) -> dict:
        return self.authorizer_with_key(service, server_challenge)[0]

    def authorizer_with_key(self, service: str,
                            server_challenge: str | None = None
                            ) -> tuple[dict, bytes]:
        """((ticket, nonce, mac), session_key) to present to a daemon;
        refreshes the service ticket when missing or expired. The key
        is returned ALONGSIDE so the caller can verify the daemon's
        mutual-auth reply against the key that built this authorizer
        even if a concurrent refresh swaps the cached ticket. A server
        challenge (NeedChallenge) is bound into the MAC — the
        anti-replay round."""
        for _ in range(2):
            with self._lock:
                ent = self._svc.get(service)
                if ent is not None \
                        and self.now() <= ent["expires"] - 1.0:
                    # fast path: cached valid ticket, zero I/O under
                    # the lock — concurrent callers for other
                    # services never wait behind a monitor hunt
                    nonce = os.urandom(16)
                    az = {"ticket": ent["ticket"], "nonce": _b(nonce),
                          "mac": _b(_hmac(ent["key"], nonce,
                                          _ub(server_challenge or "")))}
                    if server_challenge is not None:
                        az["server_challenge"] = server_challenge
                    return az, ent["key"]
            # slow path OUTSIDE the fast-path lock window: the fetch
            # takes the lock itself around state updates; two racing
            # refreshes are idempotent
            self.fetch_tickets([service])
        raise AuthError(f"could not obtain a {service!r} ticket")

    def verify_reply(self, service: str, authorizer: dict,
                     reply_mac: bytes,
                     key: bytes | None = None) -> bool:
        """Mutual auth: did the daemon prove it unsealed our ticket
        (i.e. holds the rotating secret)? Pass the key returned by
        authorizer_with_key when other threads may refresh tickets
        concurrently."""
        if key is None:
            with self._lock:
                key = self._svc[service]["key"]
        want = _hmac(key, _ub(authorizer["nonce"]), b"server")
        return hmac.compare_digest(want, reply_mac)


class ServiceVerifier:
    """Daemon-side authorizer check (ref: CephxAuthorizeHandler +
    the rotating secrets a daemon refreshes from the monitor).

    Replay defense: the first authorize from a peer is answered with
    NeedChallenge carrying a single-use server challenge; only an
    authorizer whose MAC binds that challenge is accepted (producing
    it requires the sealed session key, which a frame-capturing
    attacker never has). Peer identity here is the transport's —
    binding challenges to the right connection is the messenger's
    secure mode's job, as upstream."""

    MAX_CHALLENGES = 1024

    def __init__(self, service: str,
                 rotating: list[tuple[int, str, float]],
                 now_fn=_time.time):
        self.service = service
        self.now = now_fn
        self._secrets = {sid: (_ub(key), exp)
                         for sid, key, exp in rotating}
        self._challenges: dict[str, str] = {}   # peer -> hex

    def refresh(self, rotating: list[tuple[int, str, float]]) -> None:
        self._secrets = {sid: (_ub(key), exp)
                         for sid, key, exp in rotating}

    def verify(self, authorizer: dict, peer: str = "") -> dict:
        """Returns {entity, caps, session_key, reply_mac}, raises
        NeedChallenge for the anti-replay round, or AuthError.
        reply_mac completes mutual auth."""
        tk = authorizer["ticket"]
        ent = self._secrets.get(tk["secret_id"])
        if ent is None:
            raise AuthError(
                f"{self.service} secret {tk['secret_id']} unknown "
                "(rotated out; client must refresh tickets)")
        rot, exp = ent
        if self.now() > exp:
            raise AuthError(f"{self.service} secret expired "
                            "(rotated out of this daemon's window)")
        t = _unseal(rot, _ub(tk["blob"]))
        if self.now() > t["expires"]:
            raise AuthError("service ticket expired")
        chal = authorizer.get("server_challenge")
        outstanding = self._challenges.get(peer)
        if chal is None or outstanding is None or chal != outstanding:
            while len(self._challenges) >= self.MAX_CHALLENGES:
                self._challenges.pop(next(iter(self._challenges)))
            fresh = os.urandom(16).hex()
            self._challenges[peer] = fresh
            raise NeedChallenge(fresh)
        key = _ub(t["session_key"])
        nonce = _ub(authorizer["nonce"])
        if not hmac.compare_digest(_hmac(key, nonce, _ub(chal)),
                                   _ub(authorizer["mac"])):
            raise AuthError("bad authorizer MAC")
        self._challenges.pop(peer, None)    # single use
        return {"entity": t["entity"],
                "caps": {s: Caps(c) for s, c in t["caps"].items()},
                "session_key": key,
                "reply_mac": _hmac(key, nonce, b"server")}


def local_authorize(cauth: "ClientAuth", verifier: ServiceVerifier,
                    service: str, peer: str = "local") -> dict:
    """In-process client<->daemon authorize handshake including the
    challenge round — what the wire tier does over MAuthOp frames."""
    az = cauth.authorizer_for(service)
    try:
        return verifier.verify(az, peer)
    except NeedChallenge as nc:
        az = cauth.authorizer_for(service, server_challenge=nc.challenge)
        return verifier.verify(az, peer)
