"""Failure-detecting training supervisor: crash + hang recovery (port of
automoe_tpu/tools/supervisor.py; it imports no framework).

The reference's recovery story is bash `set -e` + ERR traps that log and
stop the box (training/finetune_experts_carla.sh:38); restarts are manual.
Here a supervisor process owns the trainer:

  * crash detection — non-zero exit relaunches the command (bounded by
    --max-restarts), appending resume flags (e.g. `--resume full`) after
    the first attempt so training continues from the last checkpoint;
  * hang detection — training liveness is read from a heartbeat file's
    mtime (the trainer's metrics.jsonl works as-is: MetricsLogger appends
    every log_every steps). A stale heartbeat kills the child BY PID
    (never by name pattern) and counts as a failure;
  * every event goes to a JSONL log for post-mortem.

CLI (`automoe-supervise-torch`):
  python -m automoe_tpu_torch.tools.supervisor \
      --max-restarts 3 --heartbeat runs/x/metrics.jsonl \
      --heartbeat-timeout 600 --resume-args "--resume full" -- \
      python -m automoe_tpu_torch.train.cli gating ...

For mid-epoch recovery, run the trainer with `--save-every-steps N` and
supervise with `--resume-args "--resume full --resume-from step"` — the
relaunch then skips the batches the crashed epoch already consumed
(train/loop.py step checkpoints) instead of redoing the whole epoch.
"""
from __future__ import annotations

import argparse
import json
import shlex
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence


class Supervisor:
    def __init__(
        self,
        cmd: Sequence[str],
        *,
        max_restarts: int = 3,
        resume_args: Optional[Sequence[str]] = None,
        heartbeat_path: Optional[str] = None,
        heartbeat_timeout_s: Optional[float] = None,
        backoff_s: float = 1.0,
        poll_s: float = 0.2,
        grace_s: float = 5.0,
        event_log: Optional[str] = None,
    ):
        self.cmd = list(cmd)
        self.max_restarts = int(max_restarts)
        self.resume_args = list(resume_args or [])
        self.heartbeat_path = Path(heartbeat_path) if heartbeat_path else None
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.backoff_s = backoff_s
        self.poll_s = poll_s
        self.grace_s = grace_s
        self.event_log = Path(event_log) if event_log else None
        self.events: List[dict] = []

    def _log(self, event: str, **kw):
        rec = {"ts": time.time(), "event": event, **kw}
        self.events.append(rec)
        line = json.dumps(rec)
        print(f"[supervisor] {line}", flush=True)
        if self.event_log:
            self.event_log.parent.mkdir(parents=True, exist_ok=True)
            with self.event_log.open("a") as f:
                f.write(line + "\n")

    def _heartbeat_age(self) -> Optional[float]:
        if self.heartbeat_path is None or not self.heartbeat_path.exists():
            return None
        return time.time() - self.heartbeat_path.stat().st_mtime

    def _attempt_cmd(self, attempt: int) -> List[str]:
        if attempt == 0 or not self.resume_args:
            return self.cmd
        return self.cmd + self.resume_args

    def _run_once(self, attempt: int) -> int:
        cmd = self._attempt_cmd(attempt)
        self._log("launch", attempt=attempt, cmd=" ".join(map(shlex.quote, cmd)))
        start = time.time()
        proc = subprocess.Popen(cmd)
        try:
            while True:
                rc = proc.poll()
                if rc is not None:
                    return rc
                if self.heartbeat_timeout_s is not None:
                    age = self._heartbeat_age()
                    # heartbeats older than this attempt's launch are a
                    # previous run's — liveness must be re-proven by THIS
                    # child, so startup/compile time counts against the
                    # timeout too
                    launch_age = time.time() - start
                    if age is None:
                        age = launch_age
                    age = min(age, launch_age)
                    if age > self.heartbeat_timeout_s:
                        self._log("hang_detected", attempt=attempt,
                                  heartbeat_age_s=round(age, 3))
                        proc.terminate()
                        try:
                            proc.wait(timeout=self.grace_s)
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            proc.wait()
                        return -9
                time.sleep(self.poll_s)
        finally:
            if proc.poll() is None:  # supervisor itself interrupted
                proc.terminate()

    def run(self) -> int:
        attempt = 0
        while True:
            rc = self._run_once(attempt)
            if rc == 0:
                self._log("success", attempt=attempt)
                return 0
            self._log("failure", attempt=attempt, rc=rc)
            if attempt >= self.max_restarts:
                self._log("giving_up", attempts=attempt + 1)
                return rc
            attempt += 1
            time.sleep(self.backoff_s)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="crash/hang-recovering training supervisor",
        usage="%(prog)s [options] -- cmd [args...]",
    )
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--resume-args", default="",
                   help="flags appended on every relaunch after the first "
                        "attempt, e.g. '--resume full'")
    p.add_argument("--heartbeat", default=None,
                   help="file whose mtime proves liveness "
                        "(the trainer's metrics.jsonl)")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="seconds of heartbeat staleness that count as a hang")
    p.add_argument("--backoff", type=float, default=1.0)
    p.add_argument("--event-log", default=None)
    if argv is None:
        argv = sys.argv[1:]
    if "--" not in argv:
        p.error("separate the child command with --")
    split = argv.index("--")
    args = p.parse_args(argv[:split])
    cmd = argv[split + 1:]
    if not cmd:
        p.error("empty child command")
    sup = Supervisor(
        cmd,
        max_restarts=args.max_restarts,
        resume_args=shlex.split(args.resume_args),
        heartbeat_path=args.heartbeat,
        heartbeat_timeout_s=args.heartbeat_timeout,
        backoff_s=args.backoff,
        event_log=args.event_log,
    )
    return sup.run()


if __name__ == "__main__":
    raise SystemExit(main())
