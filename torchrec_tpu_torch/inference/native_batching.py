"""Native serving front: C++ batching queue + TCP predict server.

Counterpart of torchrec_tpu/inference/native_batching.py. Queuing,
deadline/size coalescing, per-feature collation, padding to the static
server batch, result demux and the wire front all live in
csrc/serving_queue.cpp (the port's copy, built with g++ by
utils/native.py); this module owns only the executor loop, the one piece
that must be Python, because the predict module is a PyTorch callable.

Request/response contract (mirrors the batcher in `batching.py`):
    submit((dense [n, D] f32, ids [F, n, L] i32)) -> Future of [n, R]
Wire contract (length-prefixed binary over TCP, localhost):
    request  [u32 'TRS1'][u32 n][n*D f32][F*n*L i32]
    response [u32 n][n*R f32]  |  [u32 0xFFFFFFFF][u32 len][msg]

The executor hands `predict_fn` two numpy buffers it owns, and with the
pipeline on it refills a buffer pair two batches later. numpy memory is
pageable, and a copy from pageable memory to the card
(`torch.from_numpy(buf).to("cuda")`, with or without `non_blocking`)
returns only once the source has been read, so a predict function that
copies its inputs to the card leaves the buffers free when it returns.
A predict function that keeps a view of a buffer past its return must
copy it first.
"""

from __future__ import annotations

import ctypes
import socket
import struct
import threading
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch

from torchrec_tpu_torch.utils.device import DeviceLike
from torchrec_tpu_torch.utils.native import build_native_lib

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_MAGIC = 0x54525331
_ERR_TAG = 0xFFFFFFFF

_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_i32p = ctypes.POINTER(ctypes.c_int32)


def _native_lib() -> ctypes.CDLL:
    """Build (once) and load the serving queue; raises with g++'s output
    if the build fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = build_native_lib("serving_queue.cpp")
            _bind(lib)
            _LIB = lib
    return _LIB


def _bind(lib: ctypes.CDLL) -> None:
    lib.srv_create.restype = ctypes.c_void_p
    lib.srv_create.argtypes = [ctypes.c_int] * 5 + [
        ctypes.c_int64, ctypes.c_int]
    lib.srv_submit.restype = ctypes.c_int64
    lib.srv_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _c_f32p, _c_i32p, ctypes.c_int]
    lib.srv_next_done.restype = ctypes.c_int
    lib.srv_next_done.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int)]
    lib.srv_collect.restype = ctypes.c_int
    lib.srv_collect.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _c_f32p, ctypes.c_char_p,
        ctypes.c_int]
    lib.srv_next_batch.restype = ctypes.c_int
    lib.srv_next_batch.argtypes = [
        ctypes.c_void_p, _c_f32p, _c_i32p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.srv_complete.restype = ctypes.c_int
    lib.srv_complete.argtypes = [ctypes.c_void_p, ctypes.c_int64, _c_f32p]
    lib.srv_fail_batch.restype = ctypes.c_int
    lib.srv_fail_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
    lib.srv_wait.restype = ctypes.c_int
    lib.srv_wait.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _c_f32p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int]
    lib.srv_cancel.restype = ctypes.c_int
    lib.srv_cancel.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.srv_pending.restype = ctypes.c_int
    lib.srv_pending.argtypes = [ctypes.c_void_p]
    lib.srv_serve_tcp.restype = ctypes.c_int
    lib.srv_serve_tcp.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srv_stop.restype = None
    lib.srv_stop.argtypes = [ctypes.c_void_p]
    lib.srv_destroy.restype = None
    lib.srv_destroy.argtypes = [ctypes.c_void_p]


def native_serving_available() -> bool:
    """Whether the serving queue builds and loads here."""
    try:
        _native_lib()
    except RuntimeError:
        return False
    return True


def _leaves(tree):
    """The tensors and arrays of nested tuples, lists and dicts, in
    order."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return []


class NativePredictServer:
    """Micro-batching predict server backed by the C++ queue.

    predict_fn: (dense [B, D] f32, ids [F, B, L] i32), numpy buffers of
        the server's -> preds; preds may be [B], [B, R], or nested
        tuples / lists / dicts whose FIRST tensor or array of at least
        one dimension is taken: the wire/demux contract is a dense
        [B, R] f32 prediction.
    pipeline: hold batch k's output while batch k+1 is collated and
        dispatched; default on when `device` is a CUDA device, where the
        card computes while the host collates. device: the predict
        module's device. Pass it: the default reads `device` from
        `predict_fn` or, for a bound method, from its object, and a
        closure over the module has neither, so it defaults to the CPU
        and the pipeline to off.
    The executor thread blocks in C++ (ctypes drops the GIL), so client
    submit()/TCP threads run concurrently with device execution.
    """

    def __init__(
        self,
        predict_fn: Callable,
        batch_size: int,
        dense_dim: int,
        num_feats: int,
        num_ids_per_feat: int = 1,
        result_dim: int = 1,
        max_latency_s: float = 0.005,
        max_pending: int = 4096,
        pipeline: Optional[bool] = None,
        device: DeviceLike = None,
    ):
        lib = _native_lib()
        self._lib = lib
        self._predict = predict_fn
        self._B, self._D = int(batch_size), int(dense_dim)
        self._F, self._L = int(num_feats), int(num_ids_per_feat)
        self._R = int(result_dim)
        self._lat_us = int(max_latency_s * 1e6)
        self._h = lib.srv_create(
            self._B, self._D, self._F, self._L, self._R,
            self._lat_us, int(max_pending),
        )
        if not self._h:
            raise RuntimeError("srv_create failed (bad config)")
        self._stopped = False
        self._port: Optional[int] = None
        # DOUBLE-buffered collation: while the device computes batch k
        # (asynchronous CUDA launches), the executor blocks in C++
        # coalescing batch k+1 into the other buffer pair; the
        # reference's mem-pinner/GPUExecutor overlap, expressed through
        # the CUDA stream's asynchrony instead of a second thread
        self._dense_bufs = [np.empty((self._B, self._D), np.float32)
                            for _ in range(2)]
        self._ids_bufs = [np.empty((self._F, self._B, self._L), np.int32)
                          for _ in range(2)]
        if pipeline is None:
            # pipelining only pays when the device computes in parallel
            # with the host; on the CPU the held batch just adds client
            # latency
            if device is None:
                owner = getattr(predict_fn, "__self__", None)
                device = getattr(predict_fn, "device",
                                 getattr(owner, "device", "cpu"))
            pipeline = torch.device(device).type == "cuda"
        self._pipeline = bool(pipeline)
        # in-process futures resolve through the C++ completion queue:
        # ONE drain thread services every submit() (no per-request
        # waiter threads), mirroring the executor split
        self._futures: dict = {}   # rid -> Future awaiting resolution
        self._parked: dict = {}    # rid -> result the drain saw pre-registration
        self._fut_lock = threading.Lock()
        self._exec = threading.Thread(target=self._run, daemon=True)
        self._exec.start()
        self._drain = threading.Thread(target=self._drain_done, daemon=True)
        self._drain.start()

    # -- client side (in-process) -------------------------------------

    def submit(self, dense: np.ndarray, ids: np.ndarray) -> Future:
        """dense [n, D] f32, ids [F, n, L] i32 -> Future of [n, R] f32.
        Resolved by the completion-queue drain thread."""
        if self._stopped:  # the handle is destroyed — never call into it
            f = Future()
            f.set_exception(RuntimeError("server stopped"))
            return f
        dense = np.ascontiguousarray(dense, np.float32)
        ids = np.ascontiguousarray(ids, np.int32)
        n = ids.shape[1]
        if dense.shape != (n, self._D) or ids.shape != (self._F, n, self._L):
            raise ValueError(
                f"bad request shapes {dense.shape}/{ids.shape} for "
                f"D={self._D} F={self._F} L={self._L}"
            )
        f: Future = Future()
        # submit OUTSIDE the lock (it memcpys the payload — serializing
        # submitters behind one Python lock throttled the 8-client
        # bench); the drain parks results for ids it has not seen yet,
        # so register-after-submit cannot lose the completion
        rid = self._lib.srv_submit(
            self._h, n,
            dense.ctypes.data_as(_c_f32p) if self._D else None,
            ids.ctypes.data_as(_c_i32p), 1,
        )
        if rid >= 0:
            with self._fut_lock:
                parked = self._parked.pop(int(rid), None)
                if parked is None:
                    self._futures[int(rid)] = f
            if parked is not None:  # drain beat us to it
                self._resolve(f, *parked)
        if rid < 0:
            f.set_exception(RuntimeError(
                {-1: "server stopped", -2: "bad request size",
                 -3: "queue full"}.get(int(rid), "submit failed")
            ))
        return f

    def predict(self, dense: np.ndarray, ids: np.ndarray,
                timeout: Optional[float] = None) -> np.ndarray:
        return self.submit(dense, ids).result(timeout)

    @staticmethod
    def _resolve(f: Future, out, error: Optional[str]) -> None:
        """Resolve one future, immune to racing client cancel(): a
        cancel landing between our check and set_result would otherwise
        raise InvalidStateError and kill the SHARED drain thread."""
        try:
            if not f.set_running_or_notify_cancel():
                return  # client cancelled; drop the result
            if error is None:
                f.set_result(out)
            else:
                f.set_exception(RuntimeError(error))
        except Exception:  # noqa: BLE001 - never kill the drain loop
            pass

    def _drain_done(self) -> None:
        """Single thread resolving every in-process future: blocks in
        srv_next_done (GIL released), collects, dispatches."""
        rid = ctypes.c_int64(0)
        n = ctypes.c_int(0)
        err = ctypes.create_string_buffer(256)
        while self._lib.srv_next_done(
            self._h, ctypes.byref(rid), ctypes.byref(n)
        ):
            out = np.empty((n.value, self._R), np.float32)
            got = self._lib.srv_collect(
                self._h, rid.value, out.ctypes.data_as(_c_f32p),
                err, len(err),
            )
            error = (None if got == n.value
                     else err.value.decode() or f"srv_collect -> {got}")
            with self._fut_lock:
                f = self._futures.pop(int(rid.value), None)
                if f is None:
                    # completion observed before submit() registered the
                    # future — park it for the registration path
                    self._parked[int(rid.value)] = (out, error)
            if f is not None:
                self._resolve(f, out, error)
        # stopped: fail anything still registered
        with self._fut_lock:
            leftover = list(self._futures.values())
            self._futures.clear()
            self._parked.clear()
        for f in leftover:
            if not f.done():
                self._resolve(f, None, "server stopped")

    # -- TCP front -----------------------------------------------------

    def serve_tcp(self, port: int = 0) -> int:
        """Start the C++ TCP listener (localhost). Returns bound port."""
        p = self._lib.srv_serve_tcp(self._h, int(port))
        if p == -2:
            raise RuntimeError("serve_tcp already started for this server")
        if p < 0:
            raise RuntimeError("srv_serve_tcp failed")
        self._port = p
        return p

    @property
    def port(self) -> Optional[int]:
        return self._port

    def pending_examples(self) -> int:
        return int(self._lib.srv_pending(self._h))

    # -- executor ------------------------------------------------------

    def _post(self, bid: int, out) -> None:
        """Materialize a dispatched predict and demux it (or fail the
        batch). The copy of the first output to the CPU is where the
        executor waits for the card."""
        try:
            leaves = [x for x in _leaves(out) if x.ndim >= 1]
            first = leaves[0]
            if isinstance(first, torch.Tensor):
                first = first.detach().cpu().numpy()
            preds = np.asarray(first, np.float32).reshape(self._B, -1)
            if preds.shape[1] != self._R:
                raise ValueError(
                    f"predict_fn returned result_dim {preds.shape[1]}, "
                    f"server configured for {self._R}"
                )
            preds = np.ascontiguousarray(preds)
            self._lib.srv_complete(
                self._h, bid, preds.ctypes.data_as(_c_f32p)
            )
        except Exception as e:  # noqa: BLE001 - delivered per request
            self._lib.srv_fail_batch(self._h, bid, str(e)[:200].encode())

    def _run(self) -> None:
        bid = ctypes.c_int64(0)
        pending = None  # (bid, dispatched-but-unfetched predict output)
        k = 0
        while True:
            dense, ids = self._dense_bufs[k], self._ids_bufs[k]
            # with a dispatched batch pending, bound the wait so a lone
            # batch's results are posted even when no new traffic comes;
            # the hold must respect the server's flush-latency contract
            budget = -1 if pending is None else min(self._lat_us, 2000)
            nreq = self._lib.srv_next_batch(
                self._h,
                dense.ctypes.data_as(_c_f32p),
                ids.ctypes.data_as(_c_i32p),
                ctypes.byref(bid), budget,
            )
            if nreq == -1:  # wait budget elapsed, nothing new
                self._post(*pending)
                pending = None
                continue
            if nreq == 0:  # stopped and drained
                if pending is not None:
                    self._post(*pending)
                return
            try:
                out = self._predict(dense, ids)  # launches, no wait
            except Exception as e:  # noqa: BLE001 - delivered per request
                self._lib.srv_fail_batch(
                    self._h, bid.value, str(e)[:200].encode()
                )
                continue
            if not self._pipeline:
                self._post(bid.value, out)
                continue
            # batch k is on the device; fetching batch k-1 and collating
            # batch k+1 (next loop head, in C++ with the GIL released)
            # both overlap with its compute
            if pending is not None:
                self._post(*pending)
            pending = (bid.value, out)
            k ^= 1

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._lib.srv_stop(self._h)
        self._exec.join(timeout=10)
        self._drain.join(timeout=10)
        # srv_destroy is deferred to __del__: a submit()/waiter thread
        # racing stop() may still be inside a srv_* call, and the C++
        # side keeps every such call safe on a stopped (but live) handle

    def __del__(self):  # best-effort; explicit stop() preferred
        try:
            h, self._h = self._h, None
            if h:
                self._lib.srv_stop(h)
                self._lib.srv_destroy(h)
        except Exception:
            pass


class PredictClient:
    """Client for the TRS1 wire protocol (tests + examples).

    The reference's counterpart is the gRPC Predictor stub
    (protos/predictor.proto); this speaks the length-prefixed binary
    frame of `serving_queue.cpp` over a plain socket."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout_s: float = 60.0, result_dim: int = 1):
        # the frame does not carry R; the client knows the model it calls
        self._R = int(result_dim)
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def predict(self, dense: np.ndarray, ids: np.ndarray) -> np.ndarray:
        dense = np.ascontiguousarray(dense, np.float32)
        ids = np.ascontiguousarray(ids, np.int32)
        n = ids.shape[1]
        self._sock.sendall(
            struct.pack("<II", _MAGIC, n) + dense.tobytes() + ids.tobytes()
        )
        hdr = self._recv(4)
        (tag,) = struct.unpack("<I", hdr)
        if tag == _ERR_TAG:
            (ln,) = struct.unpack("<I", self._recv(4))
            raise RuntimeError(self._recv(ln).decode())
        if tag != n:
            raise RuntimeError(f"response for {tag} examples, sent {n}")
        out = np.frombuffer(self._recv(n * self._R * 4), np.float32)
        return out.reshape(n, self._R)

    def _recv(self, ln: int) -> bytes:
        buf = b""
        while len(buf) < ln:
            chunk = self._sock.recv(ln - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def close(self) -> None:
        self._sock.close()
