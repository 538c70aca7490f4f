"""Multi-process scaling-efficiency harness - CPU ONLY.

Measures global IK throughput at 1 vs N worker processes, each process
playing the role of one HOST: pinned to its own CPU core (taskset) with
one virtual XLA CPU device, joined into one `jax.distributed` runtime over
127.0.0.1 with the standard JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID launch contract. Every worker is forced onto the CPU
(JAX_PLATFORMS=cpu), so it never competes for a GPU; the multi-GPU path is
one process driving all cards of a host (`chip_smoke.py --four`).

The workload is embarrassingly parallel (goals shard over the global
mesh; the only collectives are the metric psums), so scaling efficiency
here measures harness overhead - coordination, compile reuse, per-process
dispatch - not algorithmic communication cost.

Usage:  python tools/scaling_bench.py [--procs 2] [--goals 64] [--reps 3]
Prints one JSON line:
  {"throughput_1p": ..., "throughput_Np": ..., "scaling_efficiency": ...}
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(n_proc: int, goals: int, reps: int, timeout: float = 900.0):
    """Launch n_proc pinned worker processes; return global solves/s."""
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="graphik_scaling_")
    have_taskset = shutil.which("taskset") is not None
    n_cpus = os.cpu_count() or 1
    procs, outs = [], []
    for pid in range(n_proc):
        out_file = os.path.join(tmp, f"proc{pid}.json")
        outs.append(out_file)
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(n_proc),
            "JAX_PROCESS_ID": str(pid),
            "GRAPHIK_GOALS": str(goals),
            "GRAPHIK_SCALING_REPS": str(reps),
            "GRAPHIK_OUT": out_file,
        })
        cmd = [sys.executable, WORKER]
        if have_taskset and n_cpus >= n_proc:
            # one core per "host": the 1-proc baseline and each member of
            # the N-proc world get the same single-core compute budget
            cmd = ["taskset", "-c", str(pid % n_cpus)] + cmd
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    failures = []
    for pid, p in enumerate(procs):
        try:
            _, stderr = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            _, stderr = p.communicate()
            failures.append((pid, "timeout", stderr.decode()[-1500:]))
            continue
        if p.returncode != 0:
            failures.append((pid, p.returncode, stderr.decode()[-1500:]))
    if failures:
        raise RuntimeError(f"worker failures: {failures}")
    recs = [json.load(open(f)) for f in outs]
    # the psum collectives synchronize the world: take the max wall
    tp = min(r["scaling"]["global_solves_per_s"] for r in recs)
    return tp, recs[0]["metrics"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--goals", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    tp1, m1 = run_world(1, args.goals, args.reps)
    tpN, mN = run_world(args.procs, args.goals, args.reps)
    eff = tpN / (args.procs * tp1)
    print(json.dumps({
        "goals": args.goals,
        "reps": args.reps,
        "procs": args.procs,
        "throughput_1p": round(tp1, 2),
        f"throughput_{args.procs}p": round(tpN, 2),
        "speedup": round(tpN / tp1, 3),
        "scaling_efficiency": round(eff, 3),
        "success_rate_1p": m1.get("success_rate"),
        f"success_rate_{args.procs}p": mN.get("success_rate"),
    }))


if __name__ == "__main__":
    main()
