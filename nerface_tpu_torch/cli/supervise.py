"""Supervised training — auto-restart from the latest checkpoint.

Port of `nerface_tpu/cli/supervise.py`: a production wrapper around
`nerface_tpu_torch.cli.train` for long schedules (the reference's paper
configs run 1M iterations, `dave_dvp_lcode_fixed_bg_512_paper_model.yml:10`,
hours to days on the card). It launches the train CLI as a child process,
watches its host RSS, and bounces it — graceful stop, resume from the
newest COMPLETE checkpoint — when it crosses a limit or crashes. Crash
recovery (nonzero child exit → resume) covers a process lost to a device
fault or a killed host job.

`--stall-timeout-seconds` additionally guards against *silent* hangs: a
child blocked forever inside the driver or a collective writes nothing
and never exits, so neither the RSS limit nor crash recovery fires.
Progress is read from the experiment logdir's newest file mtime (TB event
appends every `print_every` iters, checkpoints every `save_every`), so no
train CLI cooperation is needed; a child that writes nothing for the
timeout is recycled. SIGTERM cannot interrupt a main thread parked in a
blocking call, so the stop escalates to SIGKILL after `--grace-seconds`.

Usage:
    python -m nerface_tpu_torch.cli.supervise --rss-limit-gb 80 -- \
        --config configs/synth512_paper.yml --bf16

Everything after `--` is handed to `nerface_tpu_torch.cli.train`
verbatim, except `--load-checkpoint`, which the supervisor owns: on every
(re)launch it points the child at the newest complete `.ckpt` in the
experiment logdir, falling back to the user's own `--load-checkpoint`
(e.g. a reference torch .ckpt to warm-start from) only when the logdir
has none.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

# the backend probe: a tensor on the card and a synchronize
CUDA_PROBE = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "--rss-limit-gb", type=float, default=0.0,
        help="Restart the child when its resident set exceeds this many "
             "GiB (0 = never; crash recovery still applies).",
    )
    parser.add_argument(
        "--poll-seconds", type=float, default=30.0,
        help="RSS poll interval.",
    )
    parser.add_argument(
        "--stall-timeout-seconds", type=float, default=0.0,
        help="Restart the child when the experiment logdir sees no new "
             "writes for this long (0 = never). Catches silent "
             "hangs that neither crash nor grow RSS.",
    )
    parser.add_argument(
        "--max-restarts", type=int, default=20,
        help="Give up after this many restarts (limit + crash combined).",
    )
    parser.add_argument(
        "--outage-probe-seconds", type=float, default=120.0,
        help="After a child dies having never written to the logdir, "
             "probe the CUDA device in a subprocess; while it is "
             "unreachable, wait this long between probes instead of "
             "relaunching the (heavy) train child onto a dead device. "
             "Probe-failed cycles never count against --max-restarts. "
             "0 disables the gate.",
    )
    parser.add_argument(
        "--outage-probe-timeout-seconds", type=float, default=100.0,
        help="Per-probe subprocess timeout (a wedged driver can HANG the "
             "probe; it must be killed, not waited on).",
    )
    parser.add_argument(
        "--outage-probe-command", type=str, default="",
        help=argparse.SUPPRESS,  # test hook: shell command standing in for
        # the CUDA backend probe
    )
    parser.add_argument(
        "--grace-seconds", type=float, default=30.0,
        help="SIGTERM→SIGKILL escalation window on a limit stop.",
    )
    parser.add_argument(
        "--child-module", type=str, default="nerface_tpu_torch.cli.train",
        help=argparse.SUPPRESS,  # test hook: module to run instead of train
    )
    parser.add_argument(
        "train_args", nargs=argparse.REMAINDER,
        help="-- followed by nerface_tpu_torch.cli.train arguments.",
    )
    return parser


def rss_gb(pid: int) -> Optional[float]:
    """Resident set of `pid` in GiB via /proc (None if unreadable/gone)."""
    from nerface_tpu_torch.utils.profiling import host_rss_gb

    return host_rss_gb(pid)


def newest_mtime(root: str) -> float:
    """Most recent file mtime anywhere under `root` (0.0 if none).

    The train child appends TB events every `print_every` iterations and
    writes checkpoints every `save_every`, so this is a progress signal
    that needs no cooperation from the child."""
    latest = 0.0
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            try:
                latest = max(latest, os.stat(os.path.join(dirpath, name)).st_mtime)
            except OSError:
                continue
    return latest


def strip_load_checkpoint(train_args: List[str]) -> (List[str], str):
    """Remove `--load-checkpoint [value]` from the arg list.

    Returns (remaining_args, user_checkpoint). Handles both
    `--load-checkpoint X` and `--load-checkpoint=X` spellings."""
    out: List[str] = []
    user_ckpt = ""
    i = 0
    while i < len(train_args):
        a = train_args[i]
        if a == "--load-checkpoint":
            if i + 1 >= len(train_args):
                # fail fast: passed through, it would collide with the
                # supervisor-appended flag and argparse-error the child
                # on every relaunch until max restarts burn out
                raise SystemExit(
                    "supervise: --load-checkpoint needs a value"
                )
            user_ckpt = train_args[i + 1]
            i += 2
            continue
        if a.startswith("--load-checkpoint="):
            user_ckpt = a.split("=", 1)[1]
            i += 1
            continue
        out.append(a)
        i += 1
    return out, user_ckpt


def experiment_logdir(train_args: List[str]) -> str:
    """<cfg.experiment.logdir>/<cfg.experiment.id> from the child's
    --config (the derivation of train/loop.py::train)."""
    cfg_path = ""
    for i, a in enumerate(train_args):
        if a == "--config" and i + 1 < len(train_args):
            cfg_path = train_args[i + 1]
        elif a.startswith("--config="):
            cfg_path = a.split("=", 1)[1]
    if not cfg_path:
        raise SystemExit("supervise: no --config in train args")
    from nerface_tpu_torch.config import load_config

    cfg = load_config(cfg_path)
    return os.path.join(str(cfg.experiment.logdir), str(cfg.experiment.id))


def child_argv(
    module: str, train_args: List[str], logdir: str, user_ckpt: str
) -> List[str]:
    """Child command line with `--load-checkpoint` pointing at the newest
    complete checkpoint (user's own warm-start checkpoint on first run)."""
    from nerface_tpu_torch.train.checkpoint import latest_checkpoint

    ckpt = latest_checkpoint(logdir) or user_ckpt
    argv = [sys.executable, "-m", module] + list(train_args)
    if ckpt:
        argv += ["--load-checkpoint", ckpt]
    return argv


def backend_ready(args) -> bool:
    """One backend-liveness probe in a throwaway subprocess.

    The production probe makes a tensor on the card and synchronizes; a
    wedged driver can HANG that rather than erroring, so the subprocess is
    killed at --outage-probe-timeout-seconds and the probe reports down."""
    if args.outage_probe_command:
        argv = ["/bin/sh", "-c", args.outage_probe_command]
    else:
        argv = [sys.executable, "-c", CUDA_PROBE]
    try:
        rc = subprocess.run(
            argv,
            timeout=args.outage_probe_timeout_seconds,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        ).returncode
    except subprocess.TimeoutExpired:
        return False
    return rc == 0


def wait_for_backend(args) -> None:
    """Block until `backend_ready` — the cheap stand-in for relaunching
    the train child onto a dead device every stall-timeout cycle."""
    while True:
        time.sleep(args.outage_probe_seconds)
        if backend_ready(args):
            print("[SUPERVISE] backend reachable again — relaunching",
                  flush=True)
            return
        print(
            "[SUPERVISE] backend still unreachable; next probe in "
            f"{args.outage_probe_seconds:.0f}s",
            flush=True,
        )


def stop_child(proc: subprocess.Popen, grace_seconds: float) -> None:
    """SIGTERM, wait up to grace_seconds, then SIGKILL.

    SIGTERM lets the train CLI run its cleanup (`finally`: feed stop, the
    last save written, TB flush); a save in flight that dies anyway leaves
    a `.tmp`, which `latest_checkpoint` skips."""
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=grace_seconds)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _sigterm_to_exit(*_args) -> None:
    # default SIGTERM disposition kills the process without unwinding,
    # skipping the except-BaseException child cleanup below and orphaning
    # the train child (which keeps the card's memory); raise instead
    raise SystemExit(143)


def supervise(args) -> int:
    train_args, user_ckpt = strip_load_checkpoint(
        [a for a in args.train_args if a != "--"]
    )
    logdir = experiment_logdir(train_args)
    restarts = 0
    try:
        prev_term = signal.signal(signal.SIGTERM, _sigterm_to_exit)
    except ValueError:  # not the main thread (in-process tests)
        prev_term = None
    try:
        return _supervise_loop(args, train_args, user_ckpt, logdir, restarts)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


def _supervise_loop(args, train_args, user_ckpt, logdir, restarts) -> int:
    while True:
        argv = child_argv(args.child_module, train_args, logdir, user_ckpt)
        print(f"[SUPERVISE] launch (restart {restarts}): {' '.join(argv[2:])}",
              flush=True)
        proc = subprocess.Popen(argv)
        launched = time.time()
        limit_hit = False
        free_recycle = False
        try:
            while proc.poll() is None:
                time.sleep(args.poll_seconds)
                rss = rss_gb(proc.pid)
                if (
                    args.rss_limit_gb > 0
                    and rss is not None
                    and rss > args.rss_limit_gb
                ):
                    print(
                        f"[SUPERVISE] rss {rss:.1f} GiB > limit "
                        f"{args.rss_limit_gb:.1f} GiB — recycling child",
                        flush=True,
                    )
                    stop_child(proc, args.grace_seconds)
                    limit_hit = True
                    break
                if args.stall_timeout_seconds > 0:
                    # launch time floors the signal so a fresh child gets
                    # its full timeout to compile before the first write
                    wrote = newest_mtime(logdir) > launched
                    progress = max(launched, newest_mtime(logdir))
                    idle = time.time() - progress
                    if idle > args.stall_timeout_seconds:
                        # a child that hung WITHOUT ever writing is an
                        # infrastructure outage (e.g. backend init on a
                        # dead device), not a crash loop — recycle it
                        # without burning the restart budget, so a long
                        # outage can't exhaust --max-restarts
                        free_recycle = not wrote
                        print(
                            f"[SUPERVISE] no logdir writes for {idle:.0f}s "
                            f"(> {args.stall_timeout_seconds:.0f}s) — child "
                            "presumed hung, recycling"
                            + (" (backend outage; not counted against "
                               "max restarts)" if free_recycle else ""),
                            flush=True,
                        )
                        stop_child(proc, args.grace_seconds)
                        limit_hit = True
                        break
        except BaseException:
            # Supervisor interrupted/killed: take the child down too so a
            # later relaunch doesn't find the card still in use.
            print("[SUPERVISE] interrupted — stopping child", flush=True)
            stop_child(proc, args.grace_seconds)
            raise
        code = proc.returncode
        if not limit_hit and code == 0:
            print("[SUPERVISE] training complete", flush=True)
            return 0
        if not limit_hit:
            print(f"[SUPERVISE] child exited {code} — restarting from "
                  "latest checkpoint", flush=True)
        # A child that died having never written is either an
        # infrastructure outage or a real config/code error. Disambiguate
        # with a backend probe: unreachable device ⇒ outage — don't
        # burn the restart budget (a crash-looping init would otherwise
        # exhaust it in minutes) and don't relaunch the heavy child onto
        # a dead device; wait for the probe to come back instead.
        wrote_any = newest_mtime(logdir) > launched
        outage = free_recycle
        if (
            not wrote_any
            and args.outage_probe_seconds > 0
            and not backend_ready(args)
        ):
            outage = True
        if outage:
            if args.outage_probe_seconds > 0:
                print(
                    "[SUPERVISE] backend outage suspected — gating "
                    "relaunch on a backend probe",
                    flush=True,
                )
                wait_for_backend(args)
        else:
            restarts += 1
        if restarts > args.max_restarts:
            print("[SUPERVISE] max restarts exceeded — giving up", flush=True)
            return 1


def main(argv=None) -> None:
    sys.exit(supervise(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
