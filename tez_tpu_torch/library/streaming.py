"""Stock streaming-window processors (docs/streaming.md).

The window source/sink pair for micro-batch DAG templates run by
``tez_tpu_torch.am.streaming.StreamDriver``.  The driver stamps the window
coordinate into each window-DAG's ``dag_conf``; these processors read it
back through ``context.conf`` (TaskSpec carries the merged vertex conf)
and ``context.window_id``:

- :class:`StreamWindowSourceProcessor` reads the window's sealed spool
  (``tez.runtime.stream.input``), striping records across source tasks by
  record index — deterministic, so a window-exact replay re-emits byte-
  identical partitions.
- :class:`StreamWindowSinkProcessor` groups its input and writes window-
  tagged HIDDEN tmp part files (``.w<N>.part<i>.tmp``) into
  ``tez.runtime.stream.output-dir``; the driver's exactly-once commit
  bracket renames them to their final ``w<N>.part<i>`` names.  A task
  never publishes final names itself — that is what makes a killed
  mid-window attempt harmless (its tmp is overwritten by the replay) and
  the commit idempotent.

The port's copy of tez_tpu.library.streaming.
"""
from __future__ import annotations

from typing import Dict

from tez_tpu_torch.api.runtime import LogicalInput, LogicalOutput
from tez_tpu_torch.library.processors import SimpleProcessor


class StreamWindowSourceProcessor(SimpleProcessor):
    """Emits one window's spool records into the shuffle edge.

    Spool records are JSON values; dicts shaped ``{"k": str, "v": num}``
    become (key, value) pairs, anything else (punctuation markers) is
    skipped.  Task ``i`` of ``p`` emits the records whose index satisfies
    ``idx % p == i``."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        from tez_tpu_torch.am.streaming import read_spool
        conf = self.context.conf
        path = str(conf.get("tez.runtime.stream.input", "") or "")
        if not path:
            raise RuntimeError(
                "StreamWindowSourceProcessor needs tez.runtime.stream.input "
                "(set by the StreamDriver when it clones the window plan)")
        records = read_spool(path)
        parallelism = max(1, self.context.vertex_parallelism)
        writers = [out.get_writer() for out in outputs.values()]
        for idx, rec in enumerate(records):
            if idx % parallelism != self.context.task_index:
                continue
            if not isinstance(rec, dict) or "k" not in rec:
                continue            # punctuation / control record
            for writer in writers:
                writer.write(str(rec["k"]).encode(), rec.get("v", 1))


class StreamWindowSinkProcessor(SimpleProcessor):
    """Groups the window's shuffled input and writes sorted ``key total``
    lines to a hidden window-tagged tmp part file.  Output is a pure
    function of the window's spool, so committed windows are bit-exact
    across replays regardless of fetch interleaving or attempt kills."""

    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None:
        import os
        conf = self.context.conf
        out_dir = str(conf.get("tez.runtime.stream.output-dir", "") or "")
        w = self.context.window_id
        if not out_dir or w <= 0:
            raise RuntimeError(
                "StreamWindowSinkProcessor needs tez.runtime.stream."
                "output-dir and a window id (driver-stamped dag_conf)")
        totals: Dict[bytes, int] = {}
        for inp in inputs.values():
            for k, vs in inp.get_reader():
                totals[k] = totals.get(k, 0) + sum(vs)
        lines = [f"{k.decode()} {v}" for k, v in sorted(totals.items())]
        os.makedirs(out_dir, exist_ok=True)
        tmp = os.path.join(
            out_dir, f".w{w:06d}.part{self.context.task_index}.tmp")
        with open(tmp, "w") as fh:
            fh.write("\n".join(lines) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
