"""Newline-JSON control protocol between supervisor and shard workers.

A copy of ``evergreen_tpu/runtime/protocol.py``: the framing, the exit
codes and every message's fields are the JAX package's, byte for byte, so
either package's supervisor reads either package's workers. The port's
workers add two fields, which a JAX supervisor ignores: ``launches`` in
the ``status`` reply, this process's kernel launch counters
(``fused_distro_stats`` launches and ``segment_sum`` launches by plan),
the port's instrument for holding the launches made in worker
processes; and ``recovery_ms`` in the boot ``hello``, the wall ms of the
recovery pass. The port's workers do not answer bench mode's ``go``
(the benchmark is not ported); an ``unknown op`` error comes back
instead.

One JSON object per line, each carrying an ``op`` field. The PRIMARY
channel is the worker's stdio — stdin carries supervisor→worker
commands, stdout carries worker→supervisor replies and unsolicited
messages (heartbeats, ``fenced``, ``bye``). The same framing also runs
over each worker's re-attachable per-shard unix-domain socket
(runtime/manifest.py): a restarted supervisor connects there and sends
``adopt`` to take over a live worker without respawning it. Structured
logging writes to stderr (utils/log.py json_line_sink), so the protocol
stream stays parseable; anything that still lands on a channel without
being a protocol message (a stray library print, a torn line from a
killed writer) is skipped by ``parse_line`` and counted by the reader —
a garbage line must never wedge the fleet.

**Supervisor fencing.** Every supervisor→worker command is stamped with
the sender's supervisor-lease epoch (``sup``, storage/lease.py
``supervisor_lease_path``). Workers track the highest epoch they have
observed and answer anything older with ``stale_sup`` instead of
executing it — two supervisors can never split-brain the fleet; the
deposed one reads the reject as its stand-down order.

Worker → supervisor ops:

  ``hello``      after lease acquisition + WAL replay + recovery:
                 shard, pid, lease epoch, recovery summary. An ADOPTION
                 hello instead carries ``adopted=true`` plus the live
                 worker's tick index / orphan-tick count — same epoch,
                 no recovery summary (nothing was recovered; the
                 process never died)
  ``heartbeat``  liveness beat on ``--hb-interval`` (supervisor kills +
                 restarts a worker that misses its deadline); carries
                 the cumulative ``stale_rejects`` count and the
                 cumulative ``cmd_silences`` count — command-staleness
                 orphan entries, the worker's detector for a ONE-WAY
                 partition where its heartbeats still flow out but no
                 supervisor command has arrived within the
                 command-silence deadline (the supervisor mirrors the
                 delta into scheduler_fleet_command_silence_total)
  ``round``      one tick's result: duration, task/distro counts,
                 degraded reason, overload level, epoch. When the tick
                 carried a solver stamp it also reports ``solve``
                 (stacked / local / skipped) and ``solve_cause`` — how
                 the shard met the solver-leader plane this round
  ``agent_done`` harness agent step finished: dispatched / unfinished
  ``load``       per-affinity-group schedulable counts + round ms
                 (rebalancing input)
  ``handoffs``   the shard's non-done durable handoff records
  ``released`` / ``primed`` / ``done`` — fenced-handoff protocol legs
  ``drained``    WAL flushed, populating stopped
  ``fenced``     the worker observed a superseded lease epoch and is
                 standing down (exit 75 follows)
  ``stale_sup``  command rejected: its ``sup`` epoch is older than one
                 already observed (split-brain guard; counted)
  ``ready`` / ``report`` — bench mode (tools/bench_sharded_plane.py)
  ``bye``        clean shutdown acknowledgement

Supervisor → worker ops: ``tick``, ``agent_sim``, ``load``,
``handoffs``, ``release``, ``prime``, ``done``, ``status``, ``drain``,
``shutdown``, ``adopt`` (take over a live worker on its control
socket — answered with the adoption ``hello``), plus bench ``go`` and
the scenario backend's ``arm_fault`` (install a PR-1 fault-plan entry
at a named seam — the ``proc_kill``/``proc_hang`` events' delivery
vehicle).

**Solver-leader stamp.** A ``tick`` may carry a ``solver`` object —
``{epoch, seq, timeout_s, dims?}`` — announcing that the sender also
holds the solver lease (storage/lease.py ``solver_lease_path``) and
will serve this round's stacked solve over the worker's shared-memory
segment (runtime/solver.py). The heavy traffic — packed input arenas
out, solved column blocks back — never touches this protocol: it rides
the per-shard shm segment, fenced by the same epoch carried here. No
stamp (orphan mode, no leader, 1-shard fleet) means the worker solves
locally, as ever.
"""
from __future__ import annotations

import json
import threading
from typing import IO, Optional

#: worker exit codes the supervisor interprets (the crash harness's
#: vocabulary: 86 = fault-plan crash kind, 70 = lease lost, 75 = fenced)
EXIT_CRASHED = 86
EXIT_LOST = 70
EXIT_FENCED = 75
#: the port's own: a card fault (``KernelError``, ``MirrorError``) ended
#: the worker, or a job plane's background runner; the supervisor
#: restarts it like any other exit
EXIT_KERNEL = 1


def send_msg(fp: IO[str], lock: Optional[threading.Lock] = None,
             **msg) -> bool:
    """Write one protocol message (one line, flushed). Returns False —
    instead of raising — when the peer is gone (closed pipe): senders
    treat a dead peer as a state to observe, not an error to unwind."""
    line = json.dumps(msg, separators=(",", ":"), default=str) + "\n"
    try:
        if lock is not None:
            with lock:
                fp.write(line)
                fp.flush()
        else:
            fp.write(line)
            fp.flush()
    except (BrokenPipeError, ValueError, OSError):
        return False
    return True


def parse_line(line: str) -> Optional[dict]:
    """One received line → message dict, or None for anything that is
    not a protocol message: torn lines (no trailing newline is the
    caller's concern; here: malformed JSON), non-object payloads, and
    objects without an ``op``. Never raises."""
    line = line.strip()
    if not line or not line.startswith("{"):
        return None
    try:
        msg = json.loads(line)
    except (json.JSONDecodeError, ValueError):
        return None
    if not isinstance(msg, dict) or not isinstance(msg.get("op"), str):
        return None
    return msg
