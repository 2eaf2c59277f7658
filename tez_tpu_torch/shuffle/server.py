"""Cross-host shuffle transport: TCP server + fetcher.

Reference parity: tez-plugins/tez-aux-services ShuffleHandler.java:159 (the
host-resident server every job's consumers fetch from, with job-token HMAC
auth and keep-alive batching) and tez-runtime-library Fetcher.java:79 (retry
with backoff, penalty accounting).  Intra-process fetches short-circuit
through tez_tpu_torch.shuffle.service; this socket path carries fetches
between runner processes and hosts.

Wire format (length-prefixed):
  greeting: 16-byte random per-connection nonce (server -> client)
  request : u32 len | JSON {path, spill, partition_lo, partition_hi, hmac-hex}
            where hmac = HMAC(token, path|spill|lo|hi|nonce) — covers the
            full canonical request and is bound to this connection, so a
            captured request cannot be replayed (SecureShuffleUtils MACs
            the entire request URL; the nonce adds replay resistance)
  response: u32 len | JSON {status, sizes:[...]} | concatenated Run blobs
Each requested partition ships as one checksummed single-partition Run blob
(ops.runformat serialization), so corruption is detected end-to-end.

The port's copy of tez_tpu.shuffle.server, on the same wire, so either
package's fetcher and pusher talk to either package's server.  A push
request lands each of its single-partition blobs in this process's push
landing zone (ShuffleService.push_publish).
"""
from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import struct
import threading
from typing import List, Optional

import numpy as np

from tez_tpu_torch.common import epoch as epoch_registry
from tez_tpu_torch.common import faults, tracing
from tez_tpu_torch.common.security import (JobTokenSecretManager,
                                           hash_from_request,
                                           shuffle_request_msg)
from tez_tpu_torch.common.tls import wrap_server_class
from tez_tpu_torch.ops.runformat import KVBatch, Run
from tez_tpu_torch.shuffle.push import PushRejected
from tez_tpu_torch.shuffle.service import (ShuffleDataNotFound, ShuffleService,
                                           local_shuffle_service)
from tez_tpu_torch.utils.backoff import ExponentialBackoff, retry_call

log = logging.getLogger(__name__)


def _run_blob(batch: KVBatch) -> bytes:
    """Serialize one partition as a single-partition Run blob (checksummed)."""
    run = Run(batch, np.array([0, batch.num_records], dtype=np.int64))
    return run.to_bytes()


def _blob_to_batch(blob: bytes) -> KVBatch:
    return Run.from_bytes(blob, where="<shuffle fetch>").batch


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        server: "ShuffleServer" = self.server  # type: ignore[assignment]
        try:
            nonce = os.urandom(16)
            self.wfile.write(nonce)
            self.wfile.flush()
            while True:  # keep-alive: serve multiple fetches per connection
                raw_len = self.rfile.read(4)
                if len(raw_len) < 4:
                    return
                (req_len,) = struct.unpack("<I", raw_len)
                req = json.loads(self.rfile.read(req_len))
                self._serve_one(server, req, nonce)
        except (ConnectionError, json.JSONDecodeError, struct.error):
            return

    def _serve_one(self, server: "ShuffleServer", req: dict,
                   nonce: bytes) -> None:
        if req.get("op") == "push":
            self._serve_push(server, req, nonce)
            return
        path = req.get("path", "")
        spill = int(req.get("spill", -1))
        lo = int(req.get("partition_lo", 0))
        hi = int(req.get("partition_hi", lo + 1))
        sig = bytes.fromhex(req.get("hmac", ""))
        faults.fire("shuffle.serve", detail=f"{path}/{spill}")
        if not server.secrets.verify_hash(
                sig, shuffle_request_msg(path, spill, lo, hi, nonce)):
            server.auth_failures += 1   # count BEFORE replying (clients may
            self._reply({"status": "forbidden"}, [])  # observe immediately)
            return
        # epoch fencing (correctness, not auth — deliberately outside the
        # HMAC): a consumer stamped with a pre-restart AM epoch must not be
        # served; its inputs may be re-runs the zombie doesn't know about.
        # Unstamped requests (epoch 0 / legacy clients) are never fenced.
        epoch = int(req.get("epoch", 0) or 0)
        if epoch > 0:
            if epoch_registry.is_stale(str(req.get("app", "") or ""), epoch):
                faults.fire("fence.stale_epoch",
                            detail=f"shuffle.serve {path}/{spill}")
                tracing.event("fence.stale_epoch", seam="shuffle.serve",
                              reason="stale_consumer", msg_epoch=epoch,
                              src=f"{path}/{spill}")
                self._reply({"status": "fenced"}, [])
                return
        try:
            blobs = [
                _run_blob(server.service.fetch_partition(path, spill, p))
                for p in range(lo, hi)]
        except ShuffleDataNotFound:
            self._reply({"status": "not_found"}, [])
            return
        self._reply({"status": "ok",
                     "sizes": [len(b) for b in blobs]}, blobs)
        server.bytes_served += sum(len(b) for b in blobs)

    def _serve_push(self, server: "ShuffleServer", req: dict,
                    nonce: bytes) -> None:
        """Push verb: a remote mapper lands one spill's partitions in this
        host's buffer store (tez_tpu's docs/push_shuffle.md).  Request
        JSON carries ``sizes`` describing the single-partition Run blobs
        that follow it on the wire.  The blobs are drained BEFORE any
        verdict so the keep-alive stream stays framed whatever we reply.
        Replies:
        ok / retry (+retry_after_ms, admission said not now) / fenced
        (stale producer epoch) / forbidden / bad_request."""
        path = req.get("path", "")
        spill = int(req.get("spill", -1))
        lo = int(req.get("partition_lo", 0))
        hi = int(req.get("partition_hi", lo + 1))
        sizes = [int(s) for s in req.get("sizes", [])]
        blobs = [self.rfile.read(s) for s in sizes]
        sig = bytes.fromhex(req.get("hmac", ""))
        if not server.secrets.verify_hash(
                sig, shuffle_request_msg(path, spill, lo, hi, nonce)):
            server.auth_failures += 1
            self._reply({"status": "forbidden"}, [])
            return
        if len(sizes) != hi - lo or any(len(b) != s
                                        for b, s in zip(blobs, sizes)):
            self._reply({"status": "bad_request"}, [])
            return
        epoch = int(req.get("epoch", 0) or 0)
        app_id = str(req.get("app", "") or "")
        from tez_tpu_torch.common.epoch import EpochFencedError
        try:
            for i, blob in enumerate(blobs):
                run = Run.from_bytes(blob, where=f"<push {path}/{spill}>")
                server.service.push_publish(
                    path, spill, run, partition=lo + i, epoch=epoch,
                    app_id=app_id)
        except EpochFencedError:
            # push_publish already fired the fence fault point + trace
            self._reply({"status": "fenced"}, [])
            return
        except PushRejected as e:
            # partitions admitted before the rejection stay published —
            # idempotent extras the retry republishes; the pull backstop
            # covers the rest either way
            self._reply({"status": "retry",
                         "retry_after_ms": e.retry_after_ms}, [])
            return
        except (IOError, ValueError):
            self._reply({"status": "bad_request"}, [])
            return
        self._reply({"status": "ok"}, [])
        server.bytes_pushed += sum(sizes)

    def _reply(self, header: dict, blobs: List[bytes]) -> None:
        hdr = json.dumps(header).encode()
        self.wfile.write(struct.pack("<I", len(hdr)) + hdr)
        for b in blobs:
            self.wfile.write(b)
        self.wfile.flush()


class ShuffleServer:
    """Host-resident shuffle server (one per runner host)."""

    def __init__(self, secrets: JobTokenSecretManager,
                 service: Optional[ShuffleService] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self.secrets = secrets
        self.service = service or local_shuffle_service()
        # TLS termination at accept (SSLFactory analog): the HMAC
        # handshake below runs INSIDE the encrypted channel
        server_cls = wrap_server_class(socketserver.ThreadingTCPServer,
                                       ssl_context)
        self._tcp = server_cls((host, port), _Handler,
                               bind_and_activate=True)
        self._tcp.daemon_threads = True
        # handler back-references
        self._tcp.secrets = secrets          # type: ignore[attr-defined]
        self._tcp.service = self.service     # type: ignore[attr-defined]
        self._tcp.auth_failures = 0          # type: ignore[attr-defined]
        self._tcp.bytes_served = 0           # type: ignore[attr-defined]
        self._tcp.bytes_pushed = 0           # type: ignore[attr-defined]
        self._thread = threading.Thread(target=self._tcp.serve_forever,
                                        daemon=True, name="shuffle-server")

    @property
    def port(self) -> int:
        return self._tcp.server_address[1]

    @property
    def auth_failures(self) -> int:
        return self._tcp.auth_failures  # type: ignore[attr-defined]

    @property
    def bytes_served(self) -> int:
        return self._tcp.bytes_served   # type: ignore[attr-defined]

    @property
    def bytes_pushed(self) -> int:
        return self._tcp.bytes_pushed   # type: ignore[attr-defined]

    def start(self) -> "ShuffleServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()


class FetchSession:
    """One keep-alive connection serving many fetches — the server's handler
    loops per connection, so N map outputs coalesce onto one TCP connect +
    one nonce handshake (ShuffleHandler keep-alive batching;
    Fetcher.java's multi-output-per-connection fetch).

    Per-request misses (not_found/forbidden) leave the connection usable;
    OSError/struct.error mean the connection is dead — the caller discards
    the session."""

    def __init__(self, secrets: JobTokenSecretManager, host: str, port: int,
                 connect_timeout: float = 5.0, ssl_context=None,
                 read_timeout: float = 30.0, epoch: int = 0,
                 app_id: str = ""):
        self.secrets = secrets
        self.host, self.port = host, port
        # AM-epoch stamp for fetch requests (0 = unstamped): lets the server
        # fence consumers from a superseded AM incarnation
        self.epoch = epoch
        self.app_id = app_id
        faults.fire("shuffle.fetch.connect", detail=f"{host}:{port}")
        self._sk = socket.create_connection((host, port),
                                            timeout=connect_timeout)
        if ssl_context is not None:
            # handshake still under the CONNECT budget (the socket timeout
            # is connect_timeout until after the wrap)
            self._sk = ssl_context.wrap_socket(self._sk)
        # distinct read deadline (reference: tez.runtime.shuffle.read.timeout
        # vs .connect.timeout) — a server that accepts but stops answering
        # must fail the fetch into the retry/penalty path, not hang it
        self._sk.settimeout(read_timeout)
        self._fh = self._sk.makefile("rb")
        self._nonce = self._fh.read(16)
        if len(self._nonce) != 16:
            self.close()
            raise ConnectionError("shuffle server closed before nonce")

    def fetch_range(self, path: str, spill: int, lo: int,
                    hi: int) -> List[KVBatch]:
        faults.fire("shuffle.fetch.read", detail=path)
        req = json.dumps({
            "path": path, "spill": spill,
            "partition_lo": lo, "partition_hi": hi,
            "epoch": self.epoch, "app": self.app_id,
            "hmac": hash_from_request(self.secrets, path, spill, lo, hi,
                                      self._nonce).hex(),
        }).encode()
        self._sk.sendall(struct.pack("<I", len(req)) + req)
        (hdr_len,) = struct.unpack("<I", self._fh.read(4))
        header = json.loads(self._fh.read(hdr_len))
        status = header.get("status")
        if status == "not_found":
            raise ShuffleDataNotFound(f"{path}/{spill}")
        if status != "ok":
            raise PermissionError(f"shuffle fetch {status}: {path}")
        return [_blob_to_batch(self._fh.read(size))
                for size in header["sizes"]]

    def fetch(self, path: str, spill: int, partition: int) -> KVBatch:
        return self.fetch_range(path, spill, partition, partition + 1)[0]

    def close(self) -> None:
        for closer in (self._fh.close, self._sk.close):
            try:
                closer()
            except OSError:
                pass


class ShuffleFetcher:
    """Client side: fetch with retry/backoff (Fetcher.java penalty-box lite).

    Raises ShuffleDataNotFound on a definitive miss (drives the
    InputReadErrorEvent path) and ConnectionError after retries."""

    def __init__(self, secrets: JobTokenSecretManager, retries: int = 3,
                 backoff: float = 0.2, connect_timeout: float = 5.0,
                 ssl_context=None, epoch: int = 0, app_id: str = ""):
        self.secrets = secrets
        # clamp here: retry_call's retries<1 ValueError would otherwise be
        # misread by fetch() as a retryable fetch fault
        self.retries = max(1, retries)
        self.backoff = backoff
        self.connect_timeout = connect_timeout
        self.ssl_context = ssl_context
        self.epoch = epoch
        self.app_id = app_id

    def fetch(self, host: str, port: int, path: str, spill: int,
              partition_lo: int, partition_hi: int = -1) -> List[KVBatch]:
        if partition_hi < 0:
            partition_hi = partition_lo + 1

        def one_try() -> List[KVBatch]:
            session = FetchSession(self.secrets, host, port,
                                   self.connect_timeout,
                                   ssl_context=self.ssl_context,
                                   epoch=self.epoch, app_id=self.app_id)
            try:
                return session.fetch_range(path, spill, partition_lo,
                                           partition_hi)
            finally:
                session.close()

        try:
            # struct.error covers truncated responses (server died
            # mid-reply) — retryable like any connection fault
            return retry_call(
                one_try, self.retries,
                retryable=(OSError, ValueError, struct.error),
                backoff=ExponentialBackoff(self.backoff, jitter=True),
                fatal=(ShuffleDataNotFound, PermissionError))
        except (ShuffleDataNotFound, PermissionError):
            raise   # definitive: retrying cannot help
        except (OSError, ValueError, struct.error) as e:
            raise ConnectionError(
                f"fetch {host}:{port}/{path} failed after "
                f"{self.retries} tries: {e!r}") from e
