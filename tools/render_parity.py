"""Render PARITY.md from PARITY.json (+ optional bench / CIDGIK sweep data).

Usage: python tools/render_parity.py [--bench BENCH.json] [--sweep CIDGIK_SWEEP.json]
"""

import argparse
import json
import os


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parity", default="PARITY.json")
    ap.add_argument("--bench", default=None)
    ap.add_argument("--sweep", default="CIDGIK_SWEEP.json")
    ap.add_argument("--out", default="PARITY.md")
    args = ap.parse_args()

    with open(args.parity) as f:
        parity = json.load(f)

    bench = None
    if args.bench and os.path.exists(args.bench):
        with open(args.bench) as f:
            bench = json.load(f).get("configs", {})

    lines = [
        "# PARITY — success-rate denominator and measured ratios",
        "",
        "The reference cannot execute here (pymanopt/cvxpy/liegroups/numba "
        "unavailable, installs disallowed), so the denominator is this "
        "framework's faithful float64 replication of the reference "
        "algorithm under the reference's own budgets:",
        "",
        f"> {parity['harness']}, seed {parity['seed']}",
        "",
        "Criteria: *experiment* = pos err < 0.01 ∧ rot err < 0.01 ∧ "
        "limit-feasible (test_chain_2d_limits_new.py:73-77); *baseline* = "
        "pos < 1 mm ∧ rot < 1° ∧ feasible (BASELINE.md).",
        "",
        "## Reference-faithful denominator (f64 CPU, no polish)",
        "",
        "| config | n | success (experiment) | success (baseline) | baseline 95% CI | median pos err | mean iters |",
        "|---|---|---|---|---|---|---|",
    ]
    for name, r in parity["results"].items():
        ci = r.get("baseline_wilson_ci")
        ci_s = f"[{ci[0]:.3f}, {ci[1]:.3f}]" if ci else "—"
        lines.append(
            f"| {name} | {r.get('goals', '—')} | "
            f"{r['success_rate_experiment']:.3f} | "
            f"{r['success_rate_baseline']:.3f} | {ci_s} | "
            f"{r['median_pos_err']:.2e} | {r['mean_iterations']:.0f} |"
        )

    if bench:
        lines += [
            "",
            "## GPU f32 production pipeline vs denominator "
            "(baseline criterion)",
            "",
            "| config | GPU success (95% CI) | denominator | ratio | solves/s/chip |",
            "|---|---|---|---|---|",
        ]
        import sys as _sys
        _sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from graphik_tpu.utils.stats import wilson
        den_map = {
            "planar6": "planar6_limits",
            "planar10": "planar10_limits",
            "planar6_restarts2": "planar6_limits",
            "planar10_restarts2": "planar10_limits",
            "ur10": "ur10",
            "ur10_restarts4": "ur10",
            "kuka_iiwa": "kuka_iiwa",
            "lwa4d": "lwa4d",
            "ur10_table": "ur10_table",
            "ur10_table_restarts2": "ur10_table",
        }
        for cfg, b in bench.items():
            if "success_rate" not in b:
                continue
            den_name = den_map.get(cfg)
            den = (
                parity["results"].get(den_name, {})
                .get("success_rate_baseline")
                if den_name
                else None
            )
            ratio = (
                f"{b['success_rate'] / den:.3f}" if den else "—"
            )
            n_b = int(b.get("batch", 0))
            if n_b:
                lo, hi = wilson(
                    n_b, int(round(b["success_rate"] * n_b)), alpha=0.05
                )
                succ = f"{b['success_rate']:.3f} [{lo:.3f}, {hi:.3f}]"
            else:
                succ = f"{b['success_rate']:.3f}"
            lines.append(
                f"| {cfg} | {succ} | "
                f"{den if den is not None else '—'} | {ratio} | "
                f"{b.get('effective_solves_per_sec', '—')} |"
            )

    cid_cfgs = [
        c for c in (bench or {})
        if "_cidgik" in c and "error" not in bench[c]
        and "skipped_budget" not in bench[c]
    ]
    if cid_cfgs:
        lines += [
            "",
            "## CIDGIK on GPU f32 (ADMM + GN polish, the production pipeline)",
            "",
            "@1mm is pose-only; \"+feas\" additionally "
            "demands limit/obstacle feasibility of the polished q.",
            "",
            "| config | raw ADMM @1cm | polished @1cm | @1mm | @1mm+feas | median eig-sum | solves/s |",
            "|---|---|---|---|---|---|---|",
        ]
        for cfg in cid_cfgs:
            c = bench[cfg]
            eig = c.get("median_eig_sum")
            eig_s = f"{eig:.1e}" if eig is not None else "—"
            lines.append(
                f"| {cfg} | {c.get('raw_admm_rate_1cm', float('nan')):.3f} | "
                f"{c.get('success_rate_1cm', float('nan')):.3f} | "
                f"{c.get('success_rate_1mm', float('nan')):.3f} | "
                f"{c.get('success_rate_1mm_feasible', float('nan')):.3f} | "
                f"{eig_s} | {c.get('throughput_solves_per_sec', '—')} |"
            )

    if os.path.exists(args.sweep):
        with open(args.sweep) as f:
            sweep = json.load(f)
        lines += [
            "",
            "## CIDGIK success rates (f64 CPU oracle budget, "
            "dense vs sparse chordal)",
            "",
            "| config | n | success @1cm | success @1mm | feasible | median eig-sum |",
            "|---|---|---|---|---|---|",
        ]
        # merge the obstacle-scene oracle sweep when present
        obs_path = os.path.join(os.path.dirname(args.sweep) or ".",
                                "CIDGIK_OBS_SWEEP.json")
        if os.path.exists(obs_path):
            with open(obs_path) as f:
                sweep.update(json.load(f))
        for name, r in sweep.items():
            clear = r.get("clear_rate")
            clear_s = f" clear {clear:.3f}" if clear is not None else ""
            lines.append(
                f"| {name} | {r.get('goals', '—')} | "
                f"{r['success_rate_1cm']:.3f} | "
                f"{r['success_rate_1mm']:.3f} | "
                f"{r['feasible_rate']:.3f}{clear_s} | "
                f"{r['median_eig_sum']:.2e} |"
            )

    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
