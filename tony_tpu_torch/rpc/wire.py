"""Control-plane RPC: length-framed msgpack request/response over TCP.

Fills the role of the reference's Hadoop-IPC + protobuf2 control plane
(``ApplicationRpcServer.java:116-135`` server thread; retry-wrapped singleton
client ``ApplicationRpcClient.java:47-76``; 7-method service
``tensorflow_cluster_service_protos.proto:11-19`` plus the Writable metrics
channel ``rpc/MetricsRpc.java``). Differences, on purpose:

- One transport for both the application and metrics surfaces (namespaced
  methods) instead of two RPC engines on two ports — there is no Hadoop
  Writable legacy to carry here.
- msgpack framing instead of protobuf: no codegen step, and the control plane
  moves kilobytes, not tensors — the data plane is XLA collectives over
  ICI/DCN, never this channel (SURVEY.md §2.4).
- Optional shared-secret auth replaces the ClientToAMToken secret manager
  (``ApplicationMaster.java:433-452``) — but the secret itself NEVER
  crosses the wire: with a token configured, every frame carries an
  HMAC-SHA256 over (server nonce ‖ client nonce ‖ direction ‖ payload),
  keyed by the token. Both peers contribute per-connection entropy: the
  server's nonce rides the hello, the client's rides its first frame, and
  every MAC in either direction binds both. That gives peer
  authentication, frame integrity, and replay protection in BOTH
  directions — a recorded connection cannot be replayed to a client
  (the client's fresh nonce is absent from old response MACs) nor to a
  server (its fresh nonce is absent from old request MACs), and within
  a connection the server additionally requires strictly increasing
  request ids — without the cert-distribution burden of TLS on ephemeral
  TPU-VM gangs (TLS is available as an opt-in; see make_ssl_context).
  What HMAC alone does NOT give is confidentiality — the control plane
  carries cluster specs/metrics/exit codes, no secrets (the storage
  credential rides env, never RPC; see storage/store.py).

Wire format: 4-byte big-endian length, then a msgpack map per frame.
- hello (server → client, once per connection):
    {"tony-rpc": 3, "nonce": bytes, "auth": bool[, "g": int]}
- signed frame: {"p": <inner msgpack bytes>, "m": <hmac>}; unsigned: {"p"}
  (the client's FIRST frame additionally carries {"cn": bytes}, its
  connection nonce; all MACs use server_nonce + client_nonce)
- inner request:  {"id": int, "method": str, "args": {...}[, "gen": int]
                   [, "tc": [trace_id, span_id]]}
- inner response: {"id": int, "ok": bool, "result"| "error"[, "g": int]}

Trace context ("tc", tony_tpu_torch/tracing.py): a traced caller stamps its
(trace_id, parent span id) into every request, next to the generation
field; the server parks it in a thread-local around dispatch so handler-
side spans stitch under the caller's span — the cross-process edge of the
per-job trace tree. Observability hooks: ``on_request`` (server) and
``on_latency`` (client) time every call for the RPC latency histograms;
both are optional and free when unset.

Generation fencing (coordinator crash recovery): a recovered coordinator
starts with a bumped, journal-persisted generation and stamps it into the
hello and every response ("g"); fenced clients stamp theirs into every
request ("gen"). Either side seeing a LOWER generation than its own is
talking to a zombie from before a recovery — the split-brain case — and
rejects with StaleGenerationError, which is terminal (never retried: a
stale peer does not become fresh by retrying). Seeing a HIGHER generation
means a legitimate successor coordinator took over: clients adopt it
(monotonically) and carry on — that is the executor re-registration path.
Generation 0 on either side means unfenced and skips all checks.
"""

from __future__ import annotations

import hmac
import hashlib
import logging
import os
import socket
import socketserver
import ssl
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

import msgpack

from tony_tpu_torch import faults, tracing
from tony_tpu_torch.retry import RetryPolicy

log = logging.getLogger(__name__)


def server_tls_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    """TLS context for the coordinator side (RPC server / portal): present
    ``cert_path`` (PEM), key from ``key_path``. Opt-in confidentiality on
    top of the HMAC plane — reference analogue: Hadoop IPC rode the
    cluster's SASL/token machinery (``ApplicationMaster.java:433-452``);
    here the operator ships one self-signed pair via config
    (tony.application.security.tls-*)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_tls_context(cert_path: str) -> ssl.SSLContext:
    """TLS context for clients (submitter, executors): PIN the server's
    certificate (self-signed pairs on ephemeral gangs have no CA and their
    IPs aren't in any SAN — pinning the exact cert is both simpler and
    stricter than hostname verification)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.load_verify_locations(cert_path)
    return ctx

_MAX_FRAME = 64 * 1024 * 1024
_TO_SERVER = b"C"
_TO_CLIENT = b"S"


class RpcError(RuntimeError):
    pass


class AuthError(RpcError):
    pass


class RpcTimeout(RpcError):
    """A per-call send/recv deadline expired: the peer is up enough to
    hold the TCP connection but not answering — the WEDGED-coordinator
    shape, distinct from connection-refused. Classified INFRA_TRANSIENT
    (``failure_domain``) so supervisors treat it like any other transient
    infra failure rather than a user error."""

    failure_domain = "INFRA_TRANSIENT"


class FencedError(RpcError):
    """Terminal fencing rejection: the peer belongs to a superseded
    coordinator generation or a stale session epoch. Never retried —
    retrying cannot make a zombie fresh; the holder must tear itself
    down (executors: kill the user process and exit)."""


class StaleGenerationError(FencedError):
    """Generation fence specifically (see module docstring)."""


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = msgpack.packb(obj, use_bin_type=True)
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    if length > _MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    return msgpack.unpackb(_recv_exact(sock, length), raw=False)


def _mac(token: str, nonce: bytes, direction: bytes, payload: bytes) -> bytes:
    return hmac.new(token.encode(), nonce + direction + payload,
                    hashlib.sha256).digest()


def _send_signed(sock: socket.socket, obj: Any, token: Optional[str],
                 nonce: bytes, direction: bytes,
                 extra: Optional[Dict[str, Any]] = None) -> None:
    inner = msgpack.packb(obj, use_bin_type=True)
    frame: Dict[str, Any] = {"p": inner}
    if extra:
        frame.update(extra)
    if token:
        frame["m"] = _mac(token, nonce, direction, inner)
    _send_frame(sock, frame)


def _verify_frame(frame: Any, token: Optional[str],
                  nonce: bytes, direction: bytes) -> Any:
    if not isinstance(frame, dict) or "p" not in frame:
        raise RpcError("malformed frame (no payload)")
    inner = frame["p"]
    if token:
        mac = frame.get("m")
        if not isinstance(mac, (bytes, bytearray)) or not hmac.compare_digest(
                mac, _mac(token, nonce, direction, inner)):
            raise AuthError("bad or missing frame MAC")
    return msgpack.unpackb(inner, raw=False)


def _recv_signed(sock: socket.socket, token: Optional[str],
                 nonce: bytes, direction: bytes) -> Any:
    return _verify_frame(_recv_frame(sock), token, nonce, direction)


class RpcServer:
    """Threaded TCP server dispatching methods on a service object.

    Reference: ``ApplicationRpcServer`` runs as a daemon thread inside the AM
    (``ApplicationMaster.java:402``); here likewise inside the coordinator.
    Any public method of ``service`` becomes callable; a method named
    ``ns__method`` is addressed as ``"ns.method"``.
    """

    def __init__(self, service: Any, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None,
                 tls: Optional[ssl.SSLContext] = None,
                 generation: int = 0,
                 on_superseded: Optional[Any] = None,
                 on_request: Optional[Any] = None) -> None:
        self._service = service
        self._token = token or None     # "" = unauthenticated, like None
        self._tls = tls
        # Observability hook: called (method, seconds, ok) after every
        # dispatched request, with the caller's trace context still set —
        # the coordinator feeds its latency histograms and RPC spans here.
        self._on_request = on_request
        # Coordinator generation this server speaks for (0 = unfenced).
        # Fixed for the server's lifetime: a recovery is a NEW process.
        self._generation = int(generation)
        # Called (once per observation, with the newer generation) when a
        # request proves a SUCCESSOR coordinator exists — this server is
        # the zombie side of a split brain and should stand down.
        self._on_superseded = on_superseded
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one connection, many requests
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                if outer._tls is not None:
                    # Per-connection handshake (in this handler thread, so
                    # a stalling peer never blocks the accept loop); a
                    # plaintext or wrong-cert peer fails here and is
                    # dropped before any frame is read.
                    try:
                        sock = outer._tls.wrap_socket(sock, server_side=True)
                    except (ssl.SSLError, OSError) as e:
                        log.debug("TLS handshake failed from %s: %s",
                                  self.client_address, e)
                        return
                nonce = os.urandom(16)
                hello = {"tony-rpc": 3, "nonce": nonce,
                         "auth": outer._token is not None}
                if outer._generation:
                    hello["g"] = outer._generation
                try:
                    _send_frame(sock, hello)
                except OSError:
                    return
                last_id = 0
                first = True
                while True:
                    try:
                        frame = _recv_frame(sock)
                        if first:
                            # The client's first frame carries its own
                            # connection nonce; from here on every MAC
                            # (both directions) binds both nonces, so a
                            # recorded connection cannot be replayed to a
                            # fresh client — old response MACs lack this
                            # client's entropy.
                            cn = frame.get("cn", b"") \
                                if isinstance(frame, dict) else b""
                            # Exactly 16 bytes or nothing: an unauthenticated
                            # peer must not be able to inflate every HMAC for
                            # the connection's lifetime with a huge cn.
                            if isinstance(cn, (bytes, bytearray)) \
                                    and len(cn) == 16:
                                nonce = nonce + bytes(cn)
                            first = False
                        req = _verify_frame(frame, outer._token, nonce,
                                            _TO_SERVER)
                    except AuthError as e:
                        # Unauthenticated peer: say why (signed, so a
                        # legitimate client can distinguish bad-key from
                        # network damage), then drop the connection.
                        try:
                            _send_signed(
                                sock, {"id": 0, "ok": False,
                                       "error": f"AuthError: {e}"},
                                outer._token, nonce, _TO_CLIENT)
                        except OSError:
                            pass
                        return
                    except (RpcError, ConnectionError, OSError):
                        return
                    rid = req.get("id", 0) if isinstance(req, dict) else 0
                    req_gen = int(req.get("gen", 0) or 0) \
                        if isinstance(req, dict) else 0
                    if outer._token is not None and rid <= last_id:
                        # Replay of a captured frame (MAC valid, id seen):
                        # the nonce pins frames to this connection, the id
                        # ordering pins them to one use.
                        resp = {"id": rid, "ok": False,
                                "error": "AuthError: replayed request id"}
                    elif outer._generation and req_gen \
                            and req_gen < outer._generation:
                        # Frame from before a coordinator recovery: fence
                        # it out before it can touch any state. Terminal
                        # for the sender (client never retries this).
                        resp = {"id": rid, "ok": False,
                                "error": f"StaleGenerationError: frame "
                                         f"from generation {req_gen}; "
                                         f"coordinator is at generation "
                                         f"{outer._generation}"}
                    elif outer._generation and req_gen \
                            and req_gen > outer._generation:
                        # The sender has seen a NEWER coordinator: WE are
                        # the stale side of the split brain. Refuse the
                        # frame and tell the owner to stand down.
                        resp = {"id": rid, "ok": False,
                                "error": f"StaleGenerationError: this "
                                         f"coordinator (generation "
                                         f"{outer._generation}) was "
                                         f"superseded by generation "
                                         f"{req_gen}"}
                        if outer._on_superseded is not None:
                            try:
                                outer._on_superseded(req_gen)
                            except Exception:  # noqa: BLE001
                                log.exception("on_superseded callback")
                    else:
                        last_id = max(last_id, rid)
                        resp = outer._dispatch(req)
                    if outer._generation:
                        resp["g"] = outer._generation
                    try:
                        _send_signed(sock, resp, outer._token, nonce,
                                     _TO_CLIENT)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    def _dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        rid = req.get("id", 0)
        # Caller's trace context rides the frame next to the generation
        # field; park it thread-locally so handler-side spans stitch under
        # the caller's span (tony_tpu_torch/tracing.py).
        tc = req.get("tc")
        if isinstance(tc, (list, tuple)) and len(tc) == 2:
            tracing.set_rpc_context((str(tc[0]), str(tc[1])))
        t0 = time.monotonic()
        ok = True
        try:
            # Auth happened at the frame layer (_recv_signed MAC check);
            # by the time a request reaches dispatch it is authentic.
            method = str(req.get("method", "")).replace(".", "__")
            if method.startswith("_"):
                raise RpcError(f"no such method: {req.get('method')}")
            fn = getattr(self._service, method, None)
            if fn is None or not callable(fn):
                raise RpcError(f"no such method: {req.get('method')}")
            result = fn(**(req.get("args") or {}))
            return {"id": rid, "ok": True, "result": result}
        except Exception as e:  # noqa: BLE001 — must never kill the server loop
            ok = False
            if not isinstance(e, RpcError):
                log.exception("rpc handler error in %s", req.get("method"))
            return {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}
        finally:
            if self._on_request is not None:
                try:
                    self._on_request(str(req.get("method", "")),
                                     time.monotonic() - t0, ok)
                except Exception:  # noqa: BLE001 — observability only
                    log.exception("on_request hook")
            tracing.clear_rpc_context()

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address  # type: ignore[return-value]

    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> None:
        if self._thread is not None:  # idempotent
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tony-rpc-server",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        # A stopped server cannot be restarted (socket closed); reset the
        # idempotence guard so a future start() fails loudly in serve_forever
        # rather than silently no-op'ing.
        self._thread = None


class RpcClient:
    """Persistent-connection client with bounded reconnect retries.

    Reference retry policy: up to 10 attempts, 2 s FIXED sleep
    (``ApplicationRpcClient.java:66-76``) — which synchronizes a whole
    gang's reconnect storms onto the coordinator at the exact moment it
    is least able to serve them. Here the budget is the same shape
    (``max_retries`` attempts; ``retry_sleep_s`` caps any one sleep) but
    delays ramp exponentially with full jitter (tony_tpu_torch/retry.py), so N
    executors retrying the same outage spread over the window instead of
    arriving in lockstep. Tests keep fast failure via small values.
    """

    def __init__(self, host: str, port: int, token: Optional[str] = None,
                 max_retries: int = 10, retry_sleep_s: float = 2.0,
                 connect_timeout_s: float = 10.0,
                 tls: Optional[ssl.SSLContext] = None,
                 generation: int = 0,
                 call_timeout_s: Optional[float] = None,
                 on_latency: Optional[Any] = None,
                 peer: str = "") -> None:
        self._addr = (host, port)
        self._token = token or None     # "" = unauthenticated, like None
        # Wire label for directional fault scoping (rpc.partition
        # peer:NAME): which service this client dials — "coordinator",
        # "pool", "fleet". Purely observational; "" = unlabelled.
        self._peer = peer
        self._tls = tls
        # (trace_id, span_id) stamped into every request ("tc") when set —
        # the caller's edge of the cross-process span tree.
        self.trace_context: Optional[Tuple[str, str]] = None
        # Observability hook: called (method, seconds) on every SUCCESSFUL
        # call with its end-to-end latency (send→response, this attempt) —
        # executors feed their client-latency histogram here.
        self._on_latency = on_latency
        # Lowest coordinator generation this client will talk to (0 =
        # unfenced). Adopted UPWARD from server hellos/responses — a
        # successor coordinator is legitimate; a lower one is a zombie.
        self._generation = int(generation)
        # Per-call send/recv deadline. Without it a wedged (accepted the
        # connection, never answers) coordinator parks the caller forever
        # — the executor heartbeat thread being the critical victim.
        self._call_timeout_s = call_timeout_s or None
        self._max_retries = max_retries
        self._retry_sleep_s = retry_sleep_s
        self._retry_policy = RetryPolicy(
            max_attempts=max(1, max_retries),
            base_delay_s=max(retry_sleep_s / 4.0, 0.001),
            max_delay_s=max(retry_sleep_s, 0.001))
        self._connect_timeout_s = connect_timeout_s
        self._sock: Optional[socket.socket] = None
        self._nonce: bytes = b""
        self._client_nonce: bytes = b""
        self._hello_pending = False
        self._id = 0
        self._lock = threading.Lock()

    def _connect(self) -> Tuple[socket.socket, bytes, bytes, int]:
        """Dial + hello handshake, touching NO shared client state —
        call() runs this OUTSIDE the frame lock (connect can block for
        the full connect timeout; holding the lock through it would park
        every other caller thread — a sanitizer hold-while-blocking
        hazard) and installs the result under the lock.

        Returns (socket, combined nonce, client nonce, peer generation).
        """
        faults.check("rpc.connect")
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._tls is not None:
            try:
                sock = self._tls.wrap_socket(
                    sock, server_hostname=self._addr[0])
            except (ssl.SSLError, OSError):
                sock.close()
                raise
        # The connect timeout stays armed through the hello read: a peer
        # that accepts but never greets (wrong service, pre-v2 server)
        # must error out, not deadlock the first call() forever.
        try:
            hello = _recv_frame(sock)
        except (OSError, RpcError):
            sock.close()
            raise
        # Armed for every subsequent send/recv on this connection: a
        # wedged peer surfaces as socket.timeout → RpcTimeout, not a hang.
        sock.settimeout(self._call_timeout_s)
        if not isinstance(hello, dict) or "nonce" not in hello:
            sock.close()
            raise RpcError("peer is not a tony-rpc server (no hello)")
        if self._token is not None and hello.get("tony-rpc") != 3:
            # A v2 server verifies MACs over its nonce alone; our dual-nonce
            # MACs would fail there with a misleading "bad frame MAC". Name
            # the real problem instead.
            sock.close()
            raise RpcError(
                f"peer speaks tony-rpc v{hello.get('tony-rpc')}; this "
                "authenticated client requires v3 (dual-nonce MACs)")
        # Contribute our own freshness: the combined nonce goes into every
        # MAC both ways, so recorded responses from an old connection can
        # never satisfy this one (ADVICE r4: the hello alone gave the
        # client no replay protection).
        client_nonce = os.urandom(16)
        return (sock, hello["nonce"] + client_nonce, client_nonce,
                int(hello.get("g", 0) or 0))

    def _check_peer_generation(self, peer_gen: int,
                               sock: Optional[socket.socket] = None) -> None:
        """Fence or adopt: a LOWER peer generation is a zombie coordinator
        (terminal StaleGenerationError); a higher one is a legitimate
        successor and is adopted monotonically. No-op when either side is
        unfenced (generation 0)."""
        if not peer_gen or not self._generation:
            return
        if peer_gen < self._generation:
            if sock is not None:
                sock.close()
            raise StaleGenerationError(
                f"peer at {self._addr} speaks for coordinator generation "
                f"{peer_gen}; generation {self._generation} has already "
                f"been observed — refusing the stale coordinator")
        self._generation = max(self._generation, peer_gen)

    @property
    def generation(self) -> int:
        """Highest coordinator generation observed (0 = unfenced)."""
        return self._generation

    def call(self, method: str, **args: Any) -> Any:
        last_err: Optional[Exception] = None
        # The lock serializes frames on the shared socket, per ATTEMPT —
        # never across a sleep. Holding it through the backoff (the old
        # shape) parked every other caller behind one caller's outage;
        # the lock sanitizer (devtools/sanitizer.py) flags exactly that
        # hold-while-blocking hazard.
        for attempt in range(self._max_retries):
            slow = faults.fire_amount("rpc.slow")
            if slow:
                # Injected control-plane latency: the frame still goes
                # through, just late — lands in the latency histograms
                # and trace spans, never in a retry. Before the timed
                # send, and before the lock: a slow wire must not block
                # other callers' frames.
                time.sleep(slow)
            try:
                # Dial outside the lock (see _connect). The unlocked
                # read of _sock can race another caller — the loser's
                # fresh socket is closed at install time below.
                conn = self._connect() if self._sock is None else None
                with self._lock:
                    if conn is not None:
                        sock, nonce, client_nonce, peer_gen = conn
                        if self._sock is None:
                            self._check_peer_generation(peer_gen, sock)
                            self._sock = sock
                            self._nonce = nonce
                            self._client_nonce = client_nonce
                            self._hello_pending = True
                            # Request ids double as the anti-replay
                            # sequence; reset with the fresh nonce.
                            self._id = 0
                        else:
                            sock.close()    # raced: reuse the winner's
                    if self._sock is None:
                        # Concurrent caller closed the connection between
                        # our unlocked check and the lock: retry cleanly.
                        raise ConnectionResetError(
                            "connection closed by a concurrent caller")
                    # A dropped frame surfaces as a connection error and
                    # rides the same reconnect+backoff path a real reset
                    # takes (tony_tpu_torch/faults.py site table).
                    faults.check("rpc.send")
                    # Asymmetric partition, request direction: the frame
                    # dies BEFORE the send — the callee never sees it.
                    faults.check_partition("rpc.partition", "c2s",
                                           self._peer)
                    t_call = time.monotonic()
                    self._id += 1
                    req = {"id": self._id, "method": method, "args": args}
                    if self._generation:
                        req["gen"] = self._generation
                    if self.trace_context is not None:
                        req["tc"] = list(self.trace_context)
                    extra = {"cn": self._client_nonce} \
                        if self._token and self._hello_pending else None
                    _send_signed(self._sock, req, self._token, self._nonce,
                                 _TO_SERVER, extra=extra)
                    self._hello_pending = False
                    # Asymmetric partition, response direction: the
                    # request was DELIVERED — the callee processes it and
                    # its side effects land — but the response never
                    # comes back. The caller sees a reset and retries,
                    # so non-idempotent handlers rehearse the
                    # duplicate-delivery shape a real one-way cut causes.
                    faults.check_partition("rpc.partition", "s2c",
                                           self._peer)
                    # Response MAC proves the SERVER holds the secret too
                    # (mutual auth); a mismatch raises AuthError and is
                    # not retried.
                    resp = _recv_signed(self._sock, self._token,
                                        self._nonce, _TO_CLIENT)
                    if self._token is not None and \
                            resp.get("id") not in (self._id, 0):
                        # Freshness: a recorded signed response from an
                        # earlier request must not answer this one (id 0
                        # = the server's pre-dispatch auth error frame).
                        raise AuthError(
                            f"response id {resp.get('id')} does not match "
                            f"request {self._id} (replayed response?)")
                    self._check_peer_generation(
                        int(resp.get("g", 0) or 0)
                        if isinstance(resp, dict) else 0)
                    if not resp.get("ok"):
                        err = resp.get("error", "unknown rpc error")
                        if err.startswith("AuthError"):
                            raise AuthError(err)
                        if err.startswith("StaleGenerationError"):
                            raise StaleGenerationError(err)
                        if err.startswith("FencedError"):
                            raise FencedError(err)
                        raise RpcError(err)
                    if self._on_latency is not None:
                        try:
                            self._on_latency(method,
                                             time.monotonic() - t_call)
                        except Exception:  # noqa: BLE001 — observability only
                            pass
                    return resp.get("result")
            except (AuthError, FencedError):
                # Both are terminal verdicts about THIS peer/process
                # pair — retrying cannot change either.
                self.close()
                raise
            except (ConnectionError, OSError) as e:
                last_err = e
                self.close()
                if attempt < self._max_retries - 1:
                    time.sleep(self._retry_policy.delay_s(attempt))
        if isinstance(last_err, socket.timeout):
            raise RpcTimeout(
                f"rpc {method} to {self._addr} timed out after "
                f"{self._max_retries} attempts of {self._call_timeout_s}s "
                f"each [INFRA_TRANSIENT]: the peer holds the connection "
                f"but does not answer")
        raise RpcError(
            f"rpc {method} to {self._addr} failed after "
            f"{self._max_retries} attempts: {last_err}")

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()
