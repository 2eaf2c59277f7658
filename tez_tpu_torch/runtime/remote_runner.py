"""Out-of-process runner: the TezChild-as-a-process analog.

Reference parity: tez-runtime-internals TezChild.java:214 — a separate
process that connects back to the AM's umbilical, loops getTask, runs tasks,
and dies when told.  Each runner also hosts a shuffle server so its outputs
are fetchable across process/host boundaries (the NM-resident ShuffleHandler
role collapses onto the runner host here).

Launch: python -m tez_tpu_torch.runtime.remote_runner
            --am-host H --am-port P --node-id NAME --device cuda
  with the job token in the TEZ_TPU_JOB_TOKEN env var (hex), mirroring the
  reference's credential handoff via the container environment.

The port's copy of tez_tpu.runtime.remote_runner.  The device comes from
``--device`` (the AM passes its own), never from an ambient default: a
runner asked for ``cuda`` on a host without a card exits non-zero with the
reason and never runs on the CPU.  With TEZ_TPU_NATIVE_SHUFFLE_DIR set the
runner serves through the native sendfile server, and a native server
that fails to build, load or start ends the runner (tez_tpu's runner falls
back to the Python server); with shuffle TLS on, the directory is ignored
with a warning, as tez_tpu does, because the native server speaks
plaintext.

With TEZ_TPU_RUNNER_STATS_DIR set, the runner rewrites
``<dir>/runner-<pid>.json`` after every task: its device and the card's
name, the kernel launches and host-library calls of its tasks
(``kernels.launches``, ``native.calls``), the wall-clock times its module
was imported, the port's modules (torch among them) were, and it first
asked the umbilical for a task, the seconds it took to load the host
library, the CUDA context and the kernels before that, its shuffle
server's bytes served and pushed into it, its buffer store's counters
and, on the card, its peak device memory.
The file is written whole and renamed into place, so a reader never sees
half of it, and no exit hook is needed (the pool ends runners with
SIGTERM).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

#: wall-clock time this module was first imported: just after the
#: interpreter started, before torch
_T_IMPORT = time.time()

log = logging.getLogger(__name__)


def _write_stats(stats_dir: str, stats: dict) -> None:
    from tez_tpu_torch.ops import kernels, native
    from tez_tpu_torch.store import local_buffer_store
    store = local_buffer_store()
    stats = dict(stats, launches=dict(kernels.launches),
                 native={k: v for k, v in native.calls.items() if v},
                 store=store.stats()["counters"] if store is not None
                 else {})
    if stats["device"] == "cuda":
        import torch
        stats["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    path = os.path.join(stats_dir, f"runner-{os.getpid()}.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(stats, fh)
    os.replace(path + ".tmp", path)


def _warm(dev) -> str:
    """Load what every task needs before the first one is asked for: the
    host library and, on the card, the CUDA context and the kernels (built
    first if missing).  Whatever fails ends the runner.  Returns the
    device's name."""
    from tez_tpu_torch.ops import _build
    _build.host_library()
    if dev.type != "cuda":
        return "cpu"
    import torch
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    _build.load()
    return torch.cuda.get_device_name(dev)


def _start_shuffle_server(secrets, advertise_host: str):
    """The runner's shuffle server: the native sendfile server over a
    write-through file store when TEZ_TPU_NATIVE_SHUFFLE_DIR is set (and
    shuffle TLS is off), else the Python server (with TLS when it is
    configured)."""
    from tez_tpu_torch.common.tls import server_context
    from tez_tpu_torch.shuffle.server import ShuffleServer
    from tez_tpu_torch.shuffle.service import local_shuffle_service
    # consumers on OTHER hosts dial advertise_host: a non-loopback
    # advertisement requires a non-loopback bind (both server flavors)
    bind_host = "127.0.0.1" if advertise_host in ("127.0.0.1", "localhost") \
        else "0.0.0.0"
    shuffle_ssl = server_context(None)   # TEZ_TPU_SSL_* from the launch env
    native_dir = os.environ.get("TEZ_TPU_NATIVE_SHUFFLE_DIR", "")
    if native_dir and shuffle_ssl is not None:
        # the C++ sendfile server has no TLS; silently serving plaintext
        # when the operator asked for encrypted shuffle would be a
        # downgrade attack on ourselves — refuse loudly, use the TLS
        # Python server
        log.warning("TEZ_TPU_NATIVE_SHUFFLE_DIR ignored: shuffle TLS is "
                    "enabled and the native server speaks plaintext; "
                    "serving via the Python TLS server instead")
        native_dir = ""
    if native_dir:
        # native sendfile data server (ShuffleHandler analog): registered
        # runs are write-through serialized to disk; remote fetches never
        # enter Python.  A failure to build, load or start raises: no
        # fallback to the Python server.
        from tez_tpu_torch.shuffle.native_server import (FileShuffleStore,
                                                         NativeShuffleServer)
        store_dir = os.path.join(native_dir, f"runner-{os.getpid()}")
        server = NativeShuffleServer(
            secrets, store_dir, host=bind_host).start()
        # attach only after the server is up
        local_shuffle_service().attach_store(FileShuffleStore(store_dir))
        return server
    return ShuffleServer(secrets, local_shuffle_service(), host=bind_host,
                         ssl_context=shuffle_ssl).start()


def run_loop(am_host: str, am_port: int, node_id: str, token_hex: str,
             idle_timeout: float = 5.0, work_dir: str = "",
             container_id: str = "", advertise_host: str = "127.0.0.1",
             max_tasks: int = 0, device: str = "cuda") -> int:
    from tez_tpu_torch.am.umbilical_server import RemoteUmbilical
    from tez_tpu_torch.api.runtime import ObjectRegistry
    from tez_tpu_torch.common.ids import ContainerId
    from tez_tpu_torch.common.security import JobTokenSecretManager
    from tez_tpu_torch.ops.device import resolve_device
    from tez_tpu_torch.runtime.task_runner import TaskRunner

    t_imported = time.time()
    # first: a runner asked for a card that is absent must not connect,
    # serve or take a task
    dev = resolve_device(device)
    stats_dir = os.environ.get("TEZ_TPU_RUNNER_STATS_DIR", "")
    stats = {"pid": os.getpid(), "node_id": node_id,
             "container_id": container_id, "device": dev.type,
             "imported_s": _T_IMPORT, "modules_s": t_imported,
             "device_name": "cpu", "tasks": 0, "first_get_task_s": None,
             "bytes_served": 0, "bytes_pushed": 0}
    t0 = time.perf_counter()
    stats["device_name"] = _warm(dev)
    stats["warm_s"] = time.perf_counter() - t0
    secrets = JobTokenSecretManager(bytes.fromhex(token_hex))
    umbilical = RemoteUmbilical(am_host, am_port, secrets)
    try:
        shuffle_server = _start_shuffle_server(secrets, advertise_host)
    except BaseException:
        umbilical.close()
        raise
    stats["server"] = type(shuffle_server).__name__
    if not container_id:
        container_id = str(ContainerId(f"app_proc_{node_id}", os.getpid()))
    registry = ObjectRegistry()
    work_dir = work_dir or tempfile.mkdtemp(prefix=f"tez-runner-{node_id}-")
    # advertise_host is what consumers dial for shuffle fetches; on a
    # multi-host deployment pass this worker's reachable address
    shuffle_meta = {"host": advertise_host, "port": shuffle_server.port,
                    "secret": secrets}
    log.info("runner %s up on %s: shuffle port %d, am %s:%d", node_id,
             dev, shuffle_server.port, am_host, am_port)
    tasks_run = 0
    try:
        while True:
            if stats["first_get_task_s"] is None:
                stats["first_get_task_s"] = time.time()
            try:
                spec = umbilical.get_task(container_id, timeout=idle_timeout,
                                          node_id=node_id)
            except ConnectionError:
                log.info("umbilical gone; runner exiting")
                break
            if spec is None:
                break  # idle: release this runner (container release)
            runner = TaskRunner(spec, umbilical, registry,
                                work_dir=work_dir, node_id=node_id,
                                service_metadata={"shuffle": shuffle_meta},
                                device=dev)
            runner.run()
            registry.clear_scope(ObjectRegistry.VERTEX)
            tasks_run += 1
            if stats_dir:
                stats["tasks"] = tasks_run
                stats["bytes_served"] = shuffle_server.bytes_served
                stats["bytes_pushed"] = getattr(shuffle_server,
                                                "bytes_pushed", 0)
                _write_stats(stats_dir, stats)
            if max_tasks and tasks_run >= max_tasks:
                # container reuse disabled: one fresh process per task
                # (tez.am.container.reuse.enabled=False; the pool respawns
                # while backlog remains)
                break
    finally:
        shuffle_server.stop()
        umbilical.close()
        log.info("runner %s done after %d tasks", node_id, tasks_run)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--am-host", default="127.0.0.1")
    parser.add_argument("--am-port", type=int, required=True)
    parser.add_argument("--node-id", default=f"proc-{os.getpid()}")
    parser.add_argument("--container-id", default="")
    parser.add_argument("--advertise-host", default="127.0.0.1")
    parser.add_argument("--idle-timeout", type=float, default=5.0)
    parser.add_argument("--max-tasks", type=int, default=0,
                        help="exit after N tasks; 0 = loop until idle "
                             "(tez.am.container.reuse.enabled=False -> 1)")
    parser.add_argument("--device", default="cuda",
                        help="where the tasks' data plane runs (the AM's "
                             "device); cuda without a card exits non-zero")
    args = parser.parse_args()
    token = os.environ.get("TEZ_TPU_JOB_TOKEN", "")
    if not token:
        print("TEZ_TPU_JOB_TOKEN env var required", file=sys.stderr)
        return 2
    logging.basicConfig(level=os.environ.get("TEZ_TPU_LOG", "INFO"))
    from tez_tpu_torch.common import ndc
    ndc.install()   # every task log line carries its attempt id (%(ndc)s)
    try:
        return run_loop(args.am_host, args.am_port, args.node_id, token,
                        idle_timeout=args.idle_timeout,
                        container_id=args.container_id,
                        advertise_host=args.advertise_host,
                        max_tasks=args.max_tasks, device=args.device)
    except RuntimeError as e:
        # no card for --device cuda, a native server that cannot start:
        # the reason goes to stderr and the runner exits non-zero
        print(f"remote_runner: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
