"""Render the port's results summary from its experiment outputs (counterpart
of ``experiments/make_results_summary.py``, without pandas).

It reads the port's own trees under ``--root`` (default: this package's
directory): the UCI mains' ``uci/<task>/outputs*/`` per-seed metric CSVs,
the curve mains' ``curves/<task>/outputs*/`` checkpoints and CSVs, the
mixture summaries ``summarise.py`` writes, the Poisson study's long CSV,
the gap-attribution CSVs ``analyse_gap`` writes and the profiler's sweeps
``profiler/outputs*/``. Each section is a function over ``root`` that
returns ``""`` when its tree is absent. Tables, win and tie counts and
significance lines are the JAX script's text, byte for byte, on the same
tree; the prose is the port's own. The JAX sections that read TPU-era
records (the bench tables, the section snapshots and the scaling curve) are
not rendered.

The markdown goes to ``--out`` and every UCI metric row to
``uci_metrics_long.csv`` beside it; nothing is written under the
reference's ``results/`` or to ``RESULTS.md``. ``--archive`` (such a long
CSV) is unioned with each tree, the rows on disk first, so a table can be
rendered from the long CSV alone.

    python -m experiments_torch.make_results_summary --out build/summary/RESULTS.md \\
        [--root DIR] [--archive build/summary/uci_metrics_long.csv] \\
        [--gap_dir DIR] [--provenance "NVIDIA H100 80GB HBM3, 700 W"]
"""

from __future__ import annotations

import argparse
import csv
import glob
import math
import os
import pickle

from experiments_torch.aggregate_seeds import (
    LONG_COLUMNS,
    TASKS,
    collect,
    group_mean,
    grouped,
    parse_cell,
    parse_value,
    read_metrics_long,
    render,
    series_mean,
    series_std,
)

ROOT = os.path.dirname(os.path.realpath(__file__))
REPO = os.path.dirname(ROOT)

# the datasets whose CSVs are real measured data (the sklearn-bundled UCI
# studies, fetch_datasets.py --sklearn-bundled); the rest are synthetic
REAL_DATASETS = {
    "regression": ("diabetes_sklearn", "wine_alcohol", "iris_petal"),
    "classification": ("breast_wdbc", "digits_even", "iris_binary", "wine_uci"),
}
ABLATION_PROTOCOLS = (
    ("outputs", "reference"),
    ("outputs_precond", "+nystrom+precond"),
    ("outputs_precond_m0", "+m0 select"),
    ("outputs_precond_map", "+m0 MAP"),
    ("outputs_precond_smooth", "+smoothed cost"),
)
LOSS_ATTRIBUTION_TOGGLES = {
    "classification": (
        ("outputs_precond_smooth", "headline (smooth+m0, J=100)"),
        ("outputs_precond_map", "smoothing off"),
        ("outputs_precond", "smoothing+m0 off"),
        ("outputs_precond_smooth_j1000", "headline, J=1000"),
        ("outputs_precond_smooth_t2", "headline, T=2 (4x chain)"),
        ("outputs_precond_smooth_eq", "headline + spread-equilibration phase"),
        ("outputs_precond_smooth_eqt2", "headline + eq AND T=2 (composed)"),
    ),
    # the regression toggles train the PLS models only; their SVGP section
    # is the headline config's, so a toggle without svgp rows is paired with
    # the headline protocol's
    "regression": (
        ("outputs_precond_map", "headline (map, J=100)"),
        ("outputs_precond_map_t2", "headline, T=2 (4x chain)"),
        ("outputs_precond_map_eq", "headline + spread-equilibration phase"),
    ),
}
GAP_TOGGLES = (("eq", "spread-equilibration"), ("t2", "T=2 (4x chain)"),
               ("eqt2", "eq AND T=2 (composed)"))
MIXTURE_RUNS = (("", "Euler, the reference's 3-point step search"),
                ("_precond", "Lambda-preconditioned integrator"),
                ("_wide", "widened step grid"),
                ("_precond_wide", "preconditioned, widened step grid"))


def _uci(root: str, task: str, protocol: str = "") -> str:
    return os.path.join(root, "uci", task, protocol)


def _paired(p, s) -> list[float]:
    """Per-seed deltas p - s over the seeds of ``p`` (first-seen order) that
    ``s`` has, as pandas' aligned subtraction orders them."""
    sv = dict(zip(s["seed"], s["value"]))
    pv = dict(zip(p["seed"], p["value"]))
    return [pv[k] - sv[k] for k in dict.fromkeys(p["seed"]) if k in sv]


def _significant(d: list[float]) -> bool:
    """The 2-sigma paired t of the JAX sections."""
    if len(d) > 1 and series_std(d) > 0:
        return abs(series_mean(d) / (series_std(d) / len(d) ** 0.5)) >= 2.0
    return False


def _read_rows(path: str) -> list[dict]:
    """A CSV's rows, each cell as pandas types it (``parse_value``)."""
    with open(path, newline="") as f:
        return [{k: parse_value(v) for k, v in r.items()} for r in csv.DictReader(f)]


def _column_mean(rows: list[dict], key: str) -> float:
    return series_mean([float(r[key]) for r in rows])


# --- the UCI protocols --------------------------------------------------------------
def _n_results(d: str, archive: str | None = None) -> int:
    """One nll row per (dataset, model, seed) of the test split."""
    long = collect(d, "test", archive)
    return sum(1 for m in long["metric"] if m == "nll")


def _headline_dir(task: str, root: str = ROOT, archive: str | None = None) -> str | None:
    """The headline outputs tree of a task, in decreasing preference: the
    residual-smoothed cost (classification), the MAP mean constant, the
    plain preconditioned run; the most preferred with at least 95% of the
    largest result count."""
    candidates = [_uci(root, task, p) for p in ("outputs_precond_smooth", "outputs_precond_map",
                                                "outputs_precond")]
    counts = {d: _n_results(d, archive) for d in candidates}
    best = max(counts.values())
    if best == 0:
        return None
    for d in candidates:
        if counts[d] >= 0.95 * best:
            return d
    return None


def head_to_head(p, s, better_low: bool) -> dict:
    """One dataset's row of the head-to-head from the PLS rows ``p`` and the
    SVGP rows ``s`` of one metric: both means, stds (ddof 1; 0 for one seed)
    and counts, the paired deltas' mean and std, whether the 2-sigma paired
    t is significant, and the winner ("pls", "svgp" or "tie"): the paired
    delta the t used decides a significant row, the means the others,
    within 1e-4 a tie."""
    pv, sv = p["value"], s["value"]
    d = _paired(p, s)
    significant, dm = _significant(d), series_mean(d)
    pm, sm = series_mean(pv), series_mean(sv)
    if significant:
        winner = "pls" if (dm < 0) == better_low else "svgp"
    elif abs(pm - sm) < 1e-4:
        winner = "tie"
    else:
        winner = "pls" if (pm < sm) == better_low else "svgp"
    return {"pls_mean": pm, "pls_std": series_std(pv) if len(pv) > 1 else 0.0,
            "pls_n": len(pv), "svgp_mean": sm, "svgp_std": series_std(sv) if len(sv) > 1 else 0.0,
            "svgp_n": len(sv), "delta": dm, "delta_std": series_std(d) if len(d) > 1 else 0.0,
            "significant": significant, "winner": winner}


def _config_name(protocol: str) -> str:
    return "config" + protocol[len("outputs"):] + ".yaml"


def uci_section(name: str, outputs: str, metrics: list[str], note: str,
                archive: str | None = None) -> str:
    out = [f"## {name}\n", note + "\n"]
    for split in ("train", "test"):
        long = collect(outputs, split, archive)
        if long.empty:
            out.append(f"({split}: no results yet)\n")
            continue
        out.append(f"### {split} split\n")
        out.append(render(long, metrics))
    return "\n".join(out)


def headline_vs_svgp_section(
    task: str = "classification",
    metrics: tuple[str, ...] = ("nll", "acc", "auc", "f1"),
    lower_better: tuple[str, ...] = ("nll", "mse", "mae"),
    datasets: tuple[str, ...] | None = None,
    title_suffix: str = "",
    pls_model: str = "pls-onb",
    svgp_model: str = "svgp",
    root: str = ROOT,
    archive: str | None = None,
) -> str:
    """PLS against SVGP on the headline protocol's test split: per dataset,
    both means, the paired-by-seed delta and the winner (a 2-sigma t on the
    per-seed deltas decides; the means break the rest, within 1e-4 a tie).
    ``datasets`` restricts the table (the real-data rollup)."""
    base = _headline_dir(task, root, archive)
    if base is None:
        return ""
    long = collect(base, "test", archive)
    if datasets is not None and not long.empty:
        long = long.where(dataset=tuple(datasets))
    if long.empty:
        return ""
    protocol = os.path.basename(base)
    out = [
        f"## PLS vs SVGP head-to-head (headline {task} protocol{title_suffix}, test split)\n",
        f"`{protocol}`: the port's {task} main, config `{_config_name(protocol)}` or a\n"
        "depth cut of it. Lower nll/mse wins, higher acc/auc/f1 wins; seed count\n"
        "in parens.\n",
    ]
    wins = {m: 0 for m in metrics}
    ties = {m: 0 for m in metrics}
    n_datasets = {m: 0 for m in metrics}
    sig = {m: {"pls": 0, "svgp": 0, "ns": 0} for m in metrics}
    for metric in metrics:
        sel = long.where(metric=metric)
        if sel.empty:
            continue
        rows = [
            f"### {metric}\n",
            f"| dataset | {pls_model} | {svgp_model} | paired delta (pls-svgp) | winner |",
            "|---|---|---|---|---|",
        ]
        for dataset in sorted(set(sel["dataset"])):
            psel = sel.where(dataset=dataset, model=pls_model)
            ssel = sel.where(dataset=dataset, model=svgp_model)
            if psel.empty or ssel.empty:
                continue
            r = head_to_head(psel, ssel, metric in lower_better)
            if r["significant"]:
                sig[metric][r["winner"]] += 1
                wins[metric] += r["winner"] == "pls"
                winner = ("**pls**" if r["winner"] == "pls" else "svgp") + " (sig)"
            else:
                sig[metric]["ns"] += 1
                ties[metric] += r["winner"] == "tie"
                wins[metric] += r["winner"] == "pls"
                winner = {"pls": "**pls**", "svgp": "svgp", "tie": "tie"}[r["winner"]] + " (ns)"
            rows.append(
                f"| {dataset} | {r['pls_mean']:.4f} +- {r['pls_std']:.4f} ({r['pls_n']}) "
                f"| {r['svgp_mean']:.4f} +- {r['svgp_std']:.4f} ({r['svgp_n']}) "
                f"| {r['delta']:+.4f} +- {r['delta_std']:.4f} | {winner} |"
            )
            n_datasets[metric] += 1
        out.append("\n".join(rows) + "\n")
    if any(n_datasets.values()):
        out.append(
            "Summary: PLS wins "
            + ", ".join(f"{wins[m]}/{n_datasets[m]} on {m}" for m in wins)
            + f" (+ ties: {sum(ties.values())}).\n"
        )
        out.append(
            "Paired-by-seed significance (2-sigma t on per-seed deltas; the\n"
            "models share each seed's split/kernel/inducing points): "
            + "; ".join(
                f"{m}: pls {sig[m]['pls']}, svgp {sig[m]['svgp']}, "
                f"indistinguishable {sig[m]['ns']}"
                for m in metrics
                if sum(sig[m].values())
            )
            + ".\n"
        )
    return "\n".join(out)


def real_data_rollup_section(root: str = ROOT, archive: str | None = None) -> str:
    """The head-to-head on the real datasets only, never blended with the
    synthetic stand-ins."""
    parts = []
    for task, metrics in (("classification", ("nll", "acc", "auc", "f1")),
                          ("regression", ("nll", "mse"))):
        s = headline_vs_svgp_section(task, metrics, datasets=REAL_DATASETS[task], root=root,
                                     archive=archive)
        if s:
            kept = [line for line in s.splitlines() if line.startswith(
                ("###", "|", "Summary:", "Paired-by-seed", "models share"))]
            parts.append("\n".join(kept).replace("### ", f"### {task} — ") + "\n")
    if not parts:
        return ""
    return "\n".join([
        "## REAL-data-only rollup (headline protocols, test split)\n",
        "Only the datasets whose CSVs are real measured data (the sklearn-bundled\n"
        "UCI studies, `fetch_datasets --sklearn-bundled`): regression "
        + ", ".join(f"`{d}`" for d in REAL_DATASETS["regression"])
        + ";\nclassification "
        + ", ".join(f"`{d}`" for d in REAL_DATASETS["classification"])
        + ". pls-onb against svgp.\n",
        *parts,
        "",
    ])


def ablation_section(task: str = "classification", model: str = "pls-onb", root: str = ROOT,
                     archive: str | None = None) -> str:
    """Mean test NLL of one PLS model per dataset under each protocol of
    ABLATION_PROTOCOLS, with the MAP protocol's SVGP beside them."""
    cols: dict[str, dict[str, str]] = {}
    datasets: set[str] = set()
    svgp: dict[str, str] = {}
    for dirname, label in ABLATION_PROTOCOLS:
        long = collect(_uci(root, task, dirname), "test", archive)
        if long.empty:
            continue
        sub = long.where(model=model, metric="nll")
        if sub.empty:
            continue
        col = {}
        for (dataset,), values in grouped(sub, ("dataset",)).items():
            col[dataset] = f"{group_mean(values):.4f} ({sum(1 for v in values if v == v)})"
            datasets.add(dataset)
        cols[label] = col
        if dirname == "outputs_precond_map":
            ssub = long.where(model="svgp", metric="nll")
            for (dataset,), values in grouped(ssub, ("dataset",)).items():
                svgp[dataset] = f"{group_mean(values):.4f} ({sum(1 for v in values if v == v)})"
    if len(cols) < 2:
        return ""
    labels = [label for _, label in ABLATION_PROTOCOLS if label in cols]
    lines = [
        "| dataset | " + " | ".join(labels) + " | svgp |",
        "|---" * (len(labels) + 2) + "|",
    ]
    for dataset in sorted(datasets):
        row = [cols[label].get(dataset, "—") for label in labels]
        lines.append(f"| {dataset} | " + " | ".join(row) + f" | {svgp.get(dataset, '—')} |")
    return "\n".join([
        f"## Protocol ablation — {task} test NLL (PLS-ONB), mean over seeds\n",
        "Each column is one protocol tree of the port's main, each adding one\n"
        "ingredient to the one before; the svgp column is the MAP protocol's.\n"
        "Seed count in parens.\n",
        *lines,
        "",
    ])


def loss_attribution_section(task: str = "classification", metric: str = "nll",
                             lower_better: bool = True, root: str = ROOT,
                             archive: str | None = None, gap_dir: str | None = None) -> str:
    """For each dataset where the headline paired test favours SVGP
    (significantly, for classification; any real dataset, for regression),
    the paired delta under each toggle tree of LOSS_ATTRIBUTION_TOGGLES, and
    a verdict per dataset; for classification, the mechanism lines from
    ``analyse_gap``'s CSVs in ``gap_dir``."""
    head = _headline_dir(task, root, archive)
    if head is None:
        return ""

    def paired(outputs: str, dataset: str):
        long = collect(outputs, "test", archive)
        if long.empty:
            return None
        sel = long.where(dataset=dataset, metric=metric)
        pv, sv = sel.where(model="pls-onb"), sel.where(model="svgp")
        if sv.empty and outputs != head:
            sv = collect(head, "test", archive).where(dataset=dataset, metric=metric,
                                                      model="svgp")
        d = _paired(pv, sv)
        if not d:
            return None
        return (series_mean(d), series_std(d) if len(d) > 1 else 0.0, len(d), _significant(d))

    def svgp_favoured(dm: float) -> bool:
        return dm > 0 if lower_better else dm < 0

    head_long = collect(head, "test", archive)
    if head_long.empty:
        return ""
    losses = []
    for dataset in sorted(set(head_long["dataset"])):
        r = paired(head, dataset)
        if r is None or not svgp_favoured(r[0]):
            continue
        if (r[3] and task == "classification") or (
                task == "regression" and dataset in REAL_DATASETS["regression"]):
            losses.append(dataset)
    if not losses:
        return ""
    toggles = LOSS_ATTRIBUTION_TOGGLES[task]
    labels = [label for _, label in toggles]
    lines = ["| dataset | " + " | ".join(labels) + " |", "|---" * (len(labels) + 1) + "|"]
    verdicts = []
    for dataset in losses:
        row, flipped, thin, measured = [], [], [], 0
        for idx, (dirname, label) in enumerate(toggles):
            r = paired(_uci(root, task, dirname), dataset)
            if r is None:
                row.append("—")
                if idx > 0:
                    thin.append(label)
                continue
            dm, dsd, n, sig = r
            tag = "svgp sig" if (sig and svgp_favoured(dm)) else ("pls sig" if sig else "ns")
            row.append(f"{dm:+.4f} +- {dsd:.4f} (n={n}, {tag})")
            if idx == 0:  # the headline column, not a toggle
                continue
            if n < 5:  # too few seeds for a verdict from this column
                thin.append(label)
            elif not (sig and svgp_favoured(dm)):
                measured += 1
                flipped.append(label)
            else:
                measured += 1
        lines.append(f"| {dataset} | " + " | ".join(row) + " |")
        unmeasured_note = f" (unmeasured/partial toggles: {', '.join(thin)})" if thin else ""
        if flipped:
            verdicts.append(
                f"- `{dataset}`: the significant loss disappears under "
                + " and under ".join(f"**{f}**" for f in flipped)
                + " — attributed to those protocol ingredients, not to the sampler."
            )
        elif measured >= 3:
            verdicts.append(
                f"- `{dataset}`: the loss survives every measured toggle "
                f"({measured} at n>=5) — a robust gap between the particle "
                "predictive and SVGP's variational family on this dataset, "
                "not a protocol artifact." + unmeasured_note
            )
        else:
            verdicts.append(
                f"- `{dataset}`: attribution pending — toggles with fewer "
                f"than 5 seeds so far: {', '.join(thin) if thin else '(missing runs)'}."
            )
    mechanism = task == "classification" and gap_dir is not None
    return "\n".join([
        f"## Loss attribution — headline {task} {metric} losses "
        "(paired delta pls−svgp per toggle)\n",
        "Each column is a tree of the port's main with one ingredient toggled,\n"
        "on the same data seeds; "
        + ("negative deltas favour PLS" if lower_better
           else f"POSITIVE deltas favour PLS ({metric} is higher-better)")
        + ". 2-sigma\npaired-by-seed t verdict in each cell.\n",
        *lines,
        "",
        *verdicts,
        "",
        _gap_mechanism_paragraphs(losses, gap_dir) if mechanism else "",
        _toggle_mechanism_paragraphs(losses, gap_dir) if mechanism else "",
    ])


def _toggle_mechanism_paragraphs(datasets: list[str], gap_dir: str) -> str:
    """The validated rows of ``analyse_gap``'s CSVs of the toggle trees
    (``gap_attribution_{eq,t2,eqt2}.csv`` in ``gap_dir``), per dataset."""
    out = []
    for tag, label in GAP_TOGGLES:
        path = os.path.join(gap_dir, f"gap_attribution_{tag}.csv")
        if not os.path.exists(path):
            continue
        rows = [r for r in _read_rows(path) if r.get("validated") is True]
        for dataset in datasets:
            sel = [r for r in rows if r["dataset"] == dataset]
            if not sel:
                continue
            lv, pv, nv, sv = (_column_mean(sel, k) for k in (
                "pls_latent_var", "pls_proj_var", "pls_noise_var", "svgp_latent_var"))
            dnll = series_mean([r["pls_nll_extended"] - r["pls_nll"] for r in sel])
            line = (
                f"- `{dataset}` under **{label}** (n={len(sel)} validated seeds): "
                f"latent var {lv:.2f} = {pv:.2f} (projection) + {nv:.2f} "
                f"(injected prior residual) vs SVGP {sv:.2f}; continuing the "
                f"selected chain moves test NLL by {dnll:+.4f} on average — "
                + ("the chains are at their stationary law; the residual "
                   "spread (and any residual loss) is the posterior "
                   "family's, not under-convergence."
                   if abs(dnll) < 5e-3
                   else "the stopping rule still fires early at this "
                   "configuration (under-convergence persists).")
            )
            if "pls_nll_temper" in sel[0] and any(
                    not math.isnan(float(r["pls_nll_temper"])) for r in sel):
                ts = [r for r in sel if not math.isnan(float(r["pls_nll_temper"]))
                      and not math.isnan(float(r["svgp_nll_temper"]))]
                td = series_mean([r["pls_nll_temper"] - r["svgp_nll_temper"] for r in ts])
                line += (
                    f" Spread-tempered (validation-fit dispersion scaling on "
                    f"BOTH models, s_pls={_column_mean(ts, 'pls_temper_s'):.2f} vs "
                    f"s_svgp={_column_mean(ts, 'svgp_temper_s'):.2f}): paired delta "
                    f"{td:+.4f}"
                    + (" — the tempered predictives are equivalent; the "
                       "entire residual gap is the dispersion the temper "
                       "layer removes." if abs(td) < 5e-3 else ".")
                )
            out.append(line)
    if not out:
        return ""
    return "\n".join(["### Mechanism at scale (toggle-tree probes, all seeds validated)\n",
                      *out, ""])


def _gap_mechanism_paragraphs(datasets: list[str], gap_dir: str) -> str:
    """Per dataset, the means of the validated rows of ``analyse_gap``'s
    CSV of the headline tree (``gap_attribution.csv`` in ``gap_dir``): the
    delta, the Monte-Carlo spread, the recalibrated delta, the latent
    variance split and the continued chain."""
    path = os.path.join(gap_dir, "gap_attribution.csv")
    if not os.path.exists(path):
        return ""
    rows = [r for r in _read_rows(path) if r.get("validated") is True]
    if not rows:
        return ("### Mechanism\n\n"
                "Pending: no probe row of `gap_attribution.csv` passed `analyse_gap`'s\n"
                "validation gate (its recomputed test NLLs against the main's).\n")
    out = ["### Mechanism (`analyse_gap` probes of the headline tree's models, "
           "validated rows only)\n"]
    for dataset in datasets:
        sub = [r for r in rows if r["dataset"] == dataset]
        if not sub:
            continue
        m = {k: _column_mean(sub, k) for k in sub[0] if isinstance(sub[0][k], (int, float))}
        bits = [
            f"delta {m['delta']:+.4f}",
            f"MC std {m['pls_mc_std']:.4f} (predictive-noise keys — not sampling noise)",
        ]
        if "pls_nll_recal" in sub[0]:
            bits.append(
                "recalibrated delta "
                f"{m['pls_nll_recal'] - m['svgp_nll_recal']:+.4f} "
                "(validation-fit logistic map on both models)"
            )
        bits.append(
            f"latent var {m['pls_latent_var']:.2f} = "
            f"{m['pls_proj_var']:.2f} (particle projection) + "
            f"{m['pls_noise_var']:.2f} (injected prior residual) "
            f"vs SVGP {m['svgp_latent_var']:.2f}"
        )
        if "pls_nll_extended" in sub[0]:
            drop = m["pls_nll"] - m["pls_nll_extended"]
            # gap-relative: continuing the chain closing half the gap or more
            # puts the loss on the stopping rule
            verdict = (
                "the energy-plateau break fires before the particle "
                "spread equilibrates (under-convergence)"
                if m["delta"] > 0 and drop >= 0.5 * m["delta"]
                else "the chain is at its stationary law — the gap is the "
                "posterior family's, not under-convergence"
            )
            bits.append(
                f"continuing the chain at the selected step size: NLL "
                f"{m['pls_nll']:.4f} -> {m['pls_nll_extended']:.4f}, "
                f"projection var {m['pls_proj_var']:.2f} -> "
                f"{m['pls_proj_var_extended']:.2f} — {verdict}"
            )
        out.append(f"- `{dataset}` (n={len(sub)}): " + "; ".join(bits) + ".")
    if len(out) == 1:
        return ""
    return "\n".join(out) + "\n"


def nystrom_section(root: str = ROOT, archive: str | None = None) -> str:
    """pls-onb under the reference ONB scaling (``outputs``) against the
    nystrom scaling (``outputs_nystrom``), regression, test split, on the
    seeds the nystrom tree covers."""
    out_all = []
    for task, metrics in (("regression", ("nll", "mse")),):
        ref = collect(_uci(root, task, "outputs"), "test", archive)
        nys = collect(_uci(root, task, "outputs_nystrom"), "test", archive)
        if ref.empty or nys.empty:
            continue
        nys_raw = nys.where(model="pls-onb", metric=metrics[0])
        seeds: dict[str, set] = {}
        for dataset, seed in zip(nys_raw["dataset"], nys_raw["seed"]):
            seeds.setdefault(dataset, set()).add(seed)
        if sum(1 for s in seeds.values() if len(s) >= 3) < 2:
            out_all.append(
                f"## ONB scaling on UCI {task} (pls-onb, test split)\n\n"
                "The `outputs_nystrom` tree holds pls-onb files for fewer than two\n"
                "datasets at three seeds or more: no table.\n"
            )
            continue
        out = [
            f"## ONB scaling on UCI {task} (pls-onb, test split)\n",
            "`outputs` (the reference scaling) against `outputs_nystrom` (the nystrom\n"
            "scaling), on the seeds the nystrom tree covers. Seed count in parens.\n",
        ]
        for metric in metrics:
            rows = [f"### {metric}\n", "| dataset | reference | nystrom |", "|---|---|---|"]
            r = ref.where(model="pls-onb", metric=metric)
            n = nys.where(model="pls-onb", metric=metric)
            r = r.where(seed=tuple(set(n["seed"])))
            for dataset in sorted(set(r["dataset"]) & set(n["dataset"])):
                rv = r.where(dataset=dataset)["value"]
                nv = n.where(dataset=dataset)["value"]
                r_sd = series_std(rv) if len(rv) > 1 else 0.0
                n_sd = series_std(nv) if len(nv) > 1 else 0.0
                rows.append(
                    f"| {dataset} | {series_mean(rv):.4f} +- {r_sd:.4f} ({len(rv)}) "
                    f"| {series_mean(nv):.4f} +- {n_sd:.4f} ({len(nv)}) |"
                )
            out.append("\n".join(rows) + "\n")
        out_all.append("\n".join(out))
    return "\n".join(out_all)


def multichip_section(root: str = ROOT) -> str:
    """The test-split tables of the regression main's ``pls.parallel`` run
    (rank 0's files, ``uci/regression/outputs_parallel``, seed 0)."""
    base = os.path.join(_uci(root, "regression", "outputs_parallel"), "0", "results")
    if not os.path.isdir(base):
        return ""
    out = [
        "## Multi-rank harness run (`pls.parallel`)\n",
        "`outputs_parallel`: the regression main with its config's `pls.parallel`\n"
        "mesh, one process a rank, rank 0's files. Test-split metrics of seed 0\n"
        "(tempered variants left out):\n",
    ]
    for metric in ("nll", "mse"):
        path = os.path.join(base, f"{metric}_test.csv")
        if not os.path.exists(path):
            continue
        with open(path, newline="") as f:
            header, row = list(csv.reader(f))[:2]
        out.append(f"### {metric} (test, dataset={row[0]})\n")
        out.append("| model | value |")
        out.append("|---|---|")
        for name in header[1:]:
            if not name.endswith("-temper"):
                out.append(f"| {name} | {parse_cell(row[header.index(name)]):.4f} |")
        out.append("")
    return "\n".join(out)


# --- the curve mains ------------------------------------------------------------------
def _curve_order() -> list[str]:
    return [f"curve{i}" for i in range(1, 11)]


def _curve_table(outputs_dirname: str, root: str = ROOT) -> list[str] | None:
    """Per curve, the step size, epochs and observation noise of the
    regression main's pls-onb checkpoint (a dict of numpy arrays and
    scalars, written by the port's main)."""
    base = os.path.join(root, "curves", "regression", outputs_dirname, "models")
    if not os.path.isdir(base):
        return None
    rows = []
    for path in sorted(glob.glob(os.path.join(base, "*", "pls-onb.pkl"))):
        curve = os.path.basename(os.path.dirname(path))
        with open(path, "rb") as f:
            payload = pickle.load(f)
        lr = payload.get("best_lr")
        rows.append(
            f"| {curve} | {lr:.1e} | {payload.get('number_of_epochs')} | "
            f"{float(payload.get('observation_noise')):.4f} |"
            if lr is not None
            else f"| {curve} | (no candidate kept) | — | — |"
        )
    return rows or None


def curves_section(root: str = ROOT) -> str:
    """The curve regression main's checkpoints: the preconditioned run
    (``outputs_precond``), then the Euler run (``outputs``)."""
    out = []
    header = ["| curve | selected step size | epochs | learned obs. noise |", "|---|---|---|---|"]
    for dirname, title in (("outputs_precond", "`discretisation: preconditioned`"),
                           ("outputs", "explicit Euler, the reference's scheme")):
        rows = _curve_table(dirname, root)
        if rows:
            out += [f"### `{dirname}`: {title}\n", *header, *rows, ""]
    if not out:
        return ""
    return "\n".join([
        "## Curve regression (sigma_true=0.2 => true noise variance 0.04)\n",
        "The step size the search kept, its epochs and the learned observation\n"
        "noise of each curve's pls-onb checkpoint.\n",
        *out,
    ])


def _curve_metric(task: str, curve: str, model: str, metric: str,
                  root: str = ROOT) -> float | None:
    path = os.path.join(root, "curves", task, "outputs", "results", curve, model,
                        f"{metric}_test.csv")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        lines = f.read().strip().splitlines()
    try:
        return float(lines[-1].split(",")[1])
    except (IndexError, ValueError):
        return None


def curve_classification_section(root: str = ROOT) -> str:
    """Per-curve test NLL and accuracy of the curve classification main:
    PLS-ONB (sigmoid) against the SVGP with a Bernoulli likelihood."""
    rows = []
    for curve in _curve_order():
        pls_nll = _curve_metric("classification", curve, "pls-onb-sigmoid", "nll", root)
        svgp_nll = _curve_metric("classification", curve, "svgp-c", "nll", root)
        pls_acc = _curve_metric("classification", curve, "pls-onb-sigmoid", "acc", root)
        svgp_acc = _curve_metric("classification", curve, "svgp-c", "acc", root)
        if pls_nll is None or svgp_nll is None:
            continue
        pls_acc = math.nan if pls_acc is None else pls_acc
        svgp_acc = math.nan if svgp_acc is None else svgp_acc
        winner = "**pls**" if pls_nll <= svgp_nll else "svgp"
        rows.append(f"| {curve} | {pls_nll:.4f} | {svgp_nll:.4f} | {pls_acc:.3f} | "
                    f"{svgp_acc:.3f} | {winner} |")
    if not rows:
        return ""
    wins = sum("**pls**" in r for r in rows)
    return "\n".join([
        "## Curve classification (test split)\n",
        "Bernoulli labels drawn from the squashed curve. PLS-ONB (sigmoid)\n"
        f"against the SVGP with a Bernoulli likelihood: PLS wins NLL on {wins}/{len(rows)} "
        "curves.\n",
        "| curve | pls nll | svgp nll | pls acc | svgp acc | nll winner |",
        "|---|---|---|---|---|---|",
        *rows,
        "",
    ])


def poisson_section(root: str = ROOT) -> str:
    """Per-curve test NLL and MSE of the curve Poisson main, both bases."""
    rows = []
    for curve in _curve_order():
        onb_nll = _curve_metric("poisson_regression", curve, "pls-onb", "nll", root)
        if onb_nll is None:
            continue
        ipb_nll, onb_mse, ipb_mse = (
            math.nan if v is None else v for v in (
                _curve_metric("poisson_regression", curve, "pls-ipb", "nll", root),
                _curve_metric("poisson_regression", curve, "pls-onb", "mse", root),
                _curve_metric("poisson_regression", curve, "pls-ipb", "mse", root)))
        rows.append(f"| {curve} | {onb_nll:.4f} | {ipb_nll:.4f} | {onb_mse:.4f} | "
                    f"{ipb_mse:.4f} |")
    if not rows:
        return ""
    return "\n".join([
        "## Curve Poisson regression (test split)\n",
        "Poisson counts with a square link; PLS with the Poisson cost on both\n"
        "bases (the protocol trains no SVGP here).\n",
        "| curve | pls-onb nll | pls-ipb nll | pls-onb mse | pls-ipb mse |",
        "|---|---|---|---|---|",
        *rows,
        "",
    ])


def poisson_study_section(path: str) -> str:
    """The Poisson study's paired-by-seed test deltas (pls - svgp-gaussian)
    of NLL and of the oracle rate RMSE per curve, from ``study.py``'s long
    CSV at ``path``."""
    if not os.path.exists(path):
        return ""
    long = [r for r in _read_rows(path) if r["split"] == "test"]
    has_hs = any(r["model"] == "pls-onb-hs" for r in long)
    rollup_model = "pls-onb-hs" if has_hs else "pls-onb-m0"
    pls_models = ("pls-onb", "pls-onb-m0") + (("pls-onb-hs",) if has_hs else ()) + ("pls-ipb",)
    wins = {"nll": [0, 0], "rate_rmse": [0, 0]}  # [pls wins, svgp wins], significant only

    def by_seed(rows, model):
        return {"seed": [r["seed"] for r in rows if r["model"] == model],
                "value": [float(r["value"]) for r in rows if r["model"] == model]}

    lines = []
    for curve in sorted({r["curve"] for r in long}):
        cells = [f"| {curve} "]
        for metric in ("nll", "rate_rmse"):
            sel = [r for r in long if r["curve"] == curve and r["metric"] == metric]
            sv = by_seed(sel, "svgp-gaussian")
            for model in pls_models:
                d = _paired(by_seed(sel, model), sv)
                if not d:
                    cells.append("| — ")
                    continue
                sig = _significant(d)
                dm = series_mean(d)
                tag = ("pls sig" if dm < 0 else "svgp sig") if sig else "ns"
                if model == rollup_model and sig:
                    wins[metric][0 if dm < 0 else 1] += 1
                cells.append(f"| {dm:+.4f} ({len(d)}, {tag}) ")
        lines.append("".join(cells) + "|")
    if not lines:
        return ""
    n_seeds = len({r["seed"] for r in long if r["metric"] == "nll"})
    return "\n".join([
        "## Poisson regression head-to-head — PLS (native Poisson cost) "
        "vs SVGP (Gaussian on counts)\n",
        "Test deltas paired by seed (pls − svgp; negative favours PLS) over up\n"
        f"to n={n_seeds} seeds, from the port's `study.py`. `nll` is the predictive\n"
        "NLL of the observed counts; `rate_rmse` the distance of each model's\n"
        "point rate from the true rate lambda(x) = f(x)^2 of the synthetic curve.\n"
        "2-sigma paired t verdicts.\n",
        "| curve | "
        + " | ".join(f"{m.removeprefix('pls-')} nll d" for m in pls_models)
        + " | "
        + " | ".join(f"{m.removeprefix('pls-')} rate d" for m in pls_models)
        + " |",
        "|---" * (2 * len(pls_models) + 1) + "|",
        *lines,
        "",
        f"Rollup ({rollup_model}, significant only): NLL {wins['nll'][0]} pls / "
        f"{wins['nll'][1]} svgp; oracle rate RMSE {wins['rate_rmse'][0]} "
        f"pls / {wins['rate_rmse'][1]} svgp (of {len(lines)} curves).",
        "",
    ])


def mixture_section(root: str = ROOT) -> str:
    """The tables ``summarise.py`` writes into each mixture outputs tree
    (``mixture_summary.md``): particles per mode and the estimated shift."""
    out = []
    for suffix, title in MIXTURE_RUNS:
        path = os.path.join(root, "curves", "mixture_likelihood", f"outputs{suffix}",
                            "mixture_summary.md")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            table = f.read().strip()
        out += [f"### `outputs{suffix}`: {title}\n", table, ""]
    if not out:
        return ""
    return "\n".join([
        "## Multimodal regression (mixture likelihood)\n",
        "Unknown-constant-shift data (Bernoulli presence p=0.5, shift 20): the\n"
        "posterior over functions is bimodal. Split and separation computed from\n"
        "the saved particles by `curves/mixture_likelihood/summarise.py`.\n",
        *out,
    ])


def profiler_section(root: str = ROOT) -> str:
    """Each profiler sweep (``profiler/outputs*``, labelled by its
    directory): per axis and model, the mean wall ms over seeds at the
    axis's first and last value."""
    out = ["## Profiler protocol (N/M/T/J sweeps)\n"]
    for base in sorted(glob.glob(os.path.join(root, "profiler", "outputs*"))):
        if not os.path.isdir(base):
            continue
        out.append(f"### `{os.path.basename(base)}`\n")
        rows = ["| axis | model | first → last (mean ms over seeds) |", "|---|---|---|"]
        for axis in sorted(os.listdir(base)):
            if not axis.endswith(".csv"):
                continue
            sweep = _read_rows(os.path.join(base, axis))
            for model in dict.fromkeys(r["model"] for r in sweep):
                ms = {}
                for r in sweep:
                    if r["model"] == model:
                        ms.setdefault(r["value"], []).append(float(r["wall_time_milliseconds"]))
                first, last = min(ms), max(ms)
                rows.append(f"| {axis[:-4]} | {model} | {group_mean(ms[first]):.1f} → "
                            f"{group_mean(ms[last]):.1f} |")
        out.append("\n".join(rows) + "\n")
    return "\n".join(out) if len(out) > 1 else ""


# --- the long CSV ---------------------------------------------------------------------
def dump_metrics_long(path: str, root: str = ROOT, archive: str | None = None) -> int:
    """Every per-seed metric CSV of every ``uci/<task>/outputs*`` tree (and
    the archive's rows, the trees' first) as one long CSV at ``path``
    (task, protocol, split, dataset, model, metric, seed, value), sorted by
    its keys; each value in the shortest text that reads back to it, NaN
    empty. Returns the rows written."""
    rows: dict[tuple, float] = {}
    for task in TASKS:
        for outputs in sorted(glob.glob(os.path.join(_uci(root, task), "outputs*"))):
            if not os.path.isdir(outputs):
                continue
            for split in ("train", "test", "validation"):
                for r in collect(outputs, split, archive).rows():
                    rows.setdefault((task, os.path.basename(outputs), split, *r[:4]), r[4])
    if archive is not None and os.path.exists(archive):
        for r in read_metrics_long(archive):
            rows.setdefault(tuple(r[:7]), r[7])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(LONG_COLUMNS)
        for key in sorted(rows):
            writer.writerow([*key, "" if math.isnan(rows[key]) else repr(rows[key])])
    return len(rows)


# --- the document ---------------------------------------------------------------------
def summary(root: str = ROOT, archive: str | None = None, gap_dir: str | None = None,
            poisson_study_csv: str | None = None, provenance: str = "not stated") -> str:
    """The whole markdown: the UCI sections, then the curve, multi-rank and
    profiler sections; sections without a tree are left out."""
    headline_cls = _headline_dir("classification", root, archive)
    headline_reg = _headline_dir("regression", root, archive)
    study = poisson_study_csv or os.path.join(root, "curves", "poisson_regression",
                                              "outputs_study", "poisson_study_long.csv")
    uci_notes = {
        "regression": "12 model variants: PLS-ONB / PLS-Student-ONB / SVGP / SVGP-Student,\n"
                      "each raw + tempered + conformalised.",
        "classification": "PLS-ONB (Bernoulli-sigmoid) and SVGP, each raw + tempered +\n"
                          "conformalised.",
    }
    uci_metrics = {"regression": ["nll", "mse", "mae"],
                   "classification": ["nll", "acc", "auc", "f1"]}
    sections = [
        "# Results of the PyTorch port's experiment mains\n",
        f"Rendered by `experiments_torch/make_results_summary.py` from the trees under\n"
        f"`{root}`" + (f" and the long CSV `{archive}`" if archive else "") + ".\n"
        f"Produced on: {provenance}.\n"
        "Each UCI table is over data seeds (mean +- std, seed count in parens);\n"
        "the real datasets (sklearn-bundled) are named in the rollup.\n",
        headline_vs_svgp_section("classification", ("nll", "acc", "auc", "f1"), root=root,
                                 archive=archive),
        headline_vs_svgp_section("regression", ("nll", "mse"), root=root, archive=archive),
        headline_vs_svgp_section("regression", ("nll", "mse"), pls_model="pls-student-onb",
                                 svgp_model="svgp-student",
                                 title_suffix=" — Student-T likelihood variants", root=root,
                                 archive=archive),
        real_data_rollup_section(root, archive),
    ]
    for task, headline in (("regression", headline_reg), ("classification", headline_cls)):
        if headline:
            sections.append(uci_section(
                f"UCI {task} — headline protocol (`{os.path.basename(headline)}`)", headline,
                uci_metrics[task], uci_notes[task], archive))
        sections.append(uci_section(
            f"UCI {task} — `outputs` (reference scaling, explicit Euler)",
            _uci(root, task, "outputs"), uci_metrics[task], uci_notes[task], archive))
    sections += [
        ablation_section(root=root, archive=archive),
        ablation_section("regression", root=root, archive=archive),
        loss_attribution_section(root=root, archive=archive, gap_dir=gap_dir),
        loss_attribution_section("classification", metric="acc", lower_better=False, root=root,
                                 archive=archive, gap_dir=gap_dir),
        loss_attribution_section("regression", root=root, archive=archive),
        nystrom_section(root, archive),
        curves_section(root),
        curve_classification_section(root),
        poisson_section(root),
        poisson_study_section(study),
        mixture_section(root),
        multichip_section(root),
        profiler_section(root),
    ]
    return "\n".join(s for s in sections if s)


def _check_destination(path: str) -> None:
    """The reference's record (``results/``, ``RESULTS.md``) is never
    written."""
    real = os.path.realpath(path)
    results = os.path.join(REPO, "results")
    if real == os.path.join(REPO, "RESULTS.md") or real.startswith(results + os.sep):
        raise ValueError(f"{path} is the reference's record; write elsewhere")


def main(argv: list[str] | None = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=ROOT,
                        help="the directory holding uci/, curves/ and profiler/ trees")
    parser.add_argument("--out", required=True, help="path of the markdown file")
    parser.add_argument("--archive", default=None,
                        help="a long CSV to union with each UCI tree (rows on disk first)")
    parser.add_argument("--gap_dir", default=None,
                        help="the directory of analyse_gap's gap_attribution*.csv")
    parser.add_argument("--poisson_study_csv", default=None,
                        help="study.py's long CSV (default: its outputs_study file under --root)")
    parser.add_argument("--provenance", default="not stated",
                        help="the device and configs that produced the trees")
    args = parser.parse_args(argv)
    long_csv = os.path.join(os.path.dirname(os.path.abspath(args.out)), "uci_metrics_long.csv")
    for path in (args.out, long_csv):
        _check_destination(path)
    text = summary(args.root, args.archive, args.gap_dir, args.poisson_study_csv,
                   args.provenance)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    n = dump_metrics_long(long_csv, args.root, args.archive)
    print(f"wrote {long_csv} ({n} rows)")
    return text


if __name__ == "__main__":
    main()
