"""Cost lint over a capture: flops and bytes of the dispatched ops and the
roofline expectation they imply, as ``apex_tpu/analysis/cost.py`` over
XLA's ``cost_analysis()``.

- ``flops``: the sum over the dispatched aten ops of
  ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s: the
  contractions, convolutions and attention; pointwise ops count 0, as
  that counter counts them);
- ``hbm-bytes``: the sum of each dispatched op's inputs' plus outputs'
  tensor bytes (views count 0).  This is an eager upper bound: every op
  reads its inputs from and writes its outputs to device memory, where a
  compiler would fuse them, and an operand read twice counts twice;
- ``roofline``: :func:`roofline_expectation` of the two, given
  ``peak_flops`` and ``peak_hbm_bytes_per_s``.

The hand-written kernels' work is opaque to the walk, as Pallas kernels
are to XLA's cost model: one ``info`` counts their launches.  The
artifact audits (:func:`audit_kernel_artifact`,
:func:`audit_bench_artifact`, :func:`audit_floor_artifacts`) are the
JAX package's, copied: they read documents, not programs.

Finding codes (``op`` field):

=====================  ==================================================
``flops``              info: the dispatched ops' flops
``hbm-bytes``          info: the dispatched ops' bytes (upper bound)
``roofline``           info: intensity + static ceiling utilization
                       (needs ``peak_flops`` / ``peak_hbm_bytes_per_s``)
``floor-above-ceiling``  error: a committed floor exceeds the physical
                       ceiling (roofline fraction / MFU > 1)
``measured-above-ceiling``  error: a committed measurement exceeds the
                       ceiling (bandwidth above HBM peak, MFU above 1,
                       HFU below MFU)
=====================  ==================================================
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional

from apex_tpu_torch.analysis.core import PassContext, register_pass
from apex_tpu_torch.analysis.report import Finding

#: measured numbers get this much slack over a hard ceiling before the
#: audit calls them impossible: timer jitter and bytes-model rounding
#: are real, sustained >5% over physics is not.
MEASURE_TOLERANCE = 0.05


def cost_table(ctx: PassContext) -> Dict[str, float]:
    """``{"flops", "hbm_bytes"}`` of the capture's records, memoized on
    the context."""
    def compute():
        recs = ctx.capture.records
        return {"flops": float(sum(r.flops for r in recs)),
                "hbm_bytes": float(sum(r.nbytes for r in recs))}
    return ctx.memo("cost_table", compute)


def roofline_expectation(flops: float, hbm_bytes: float,
                         peak_flops: float,
                         peak_hbm_bytes_per_s: float) -> dict:
    """The static roofline of a program on a chip: arithmetic
    intensity, the binding resource, and the ceiling utilization — the
    highest MFU any measurement of this program can honestly reach.
    A committed MFU floor for the lane must sit at or under
    ``ceiling_util``."""
    intensity = flops / hbm_bytes if hbm_bytes else float("inf")
    bw_bound_flops_per_s = intensity * peak_hbm_bytes_per_s
    ceiling = min(peak_flops, bw_bound_flops_per_s)
    return {
        "intensity_flops_per_byte": intensity,
        "bound": "compute" if bw_bound_flops_per_s >= peak_flops
                 else "bandwidth",
        "ceiling_flops_per_s": ceiling,
        "ceiling_util": ceiling / peak_flops if peak_flops else 0.0,
    }


def cost_pass(ctx: PassContext,
              peak_flops: Optional[float] = None,
              peak_hbm_bytes_per_s: Optional[float] = None,
              ) -> List[Finding]:
    """Record the call's flops and bytes and its opaque kernel launches;
    with the device's peaks, the static roofline expectation (the module
    docstring)."""
    table = cost_table(ctx)
    launches = sum(ctx.capture.launches.values())
    by_kernel = ", ".join(f"{k} {v}" for k, v in
                          sorted(ctx.capture.launches.items())) or "none"
    findings = [
        Finding("cost", "info",
                f"dispatched ops: {table['flops']:.4g} flops per call",
                op="flops", count=1, bytes=None),
        Finding("cost", "info",
                f"dispatched ops: {table['hbm_bytes']:.4g} bytes accessed "
                f"per call (upper bound)", op="hbm-bytes",
                bytes=int(table["hbm_bytes"])),
        Finding("cost", "info",
                f"{launches} hand-written kernel launch(es) ({by_kernel}): "
                f"their work is opaque to the walk", count=launches),
    ]
    if peak_flops and peak_hbm_bytes_per_s:
        exp = roofline_expectation(table["flops"], table["hbm_bytes"],
                                   peak_flops, peak_hbm_bytes_per_s)
        findings.append(Finding(
            "cost", "info",
            f"static roofline: intensity "
            f"{exp['intensity_flops_per_byte']:.2f} flop/byte, "
            f"{exp['bound']}-bound, ceiling utilization "
            f"{exp['ceiling_util']:.3f} — any committed MFU floor for "
            f"this lane must sit under that",
            op="roofline"))
    return findings


# ---------------------------------------------------------------------------
# committed-artifact calibration audit


def _rounds_desc(search_dir: str, pattern: str) -> List[str]:
    rounds = []
    for path in glob.glob(os.path.join(search_dir, pattern)):
        m = re.search(r"_r(\d+)\.json$", path)
        if m:
            rounds.append((int(m.group(1)), path))
    return [p for _, p in sorted(rounds, reverse=True)]


def _load(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def audit_kernel_artifact(doc: dict, name: str,
                          floors: Optional[Dict[str, float]] = None,
                          ) -> List[Finding]:
    """Physics audit of one KERNELBENCH document: measured bandwidth
    must sit under the recorded HBM peak, roofline fractions under 1,
    and any published per-kernel floor under the ceiling too."""
    findings: List[Finding] = []
    peak_gbps = doc.get("hbm_gbps_peak")
    for kname, rec in (doc.get("kernels") or {}).items():
        if not isinstance(rec, dict):
            continue
        gbps, frac = rec.get("gbps"), rec.get("roofline_frac")
        if peak_gbps and gbps and gbps > peak_gbps * (1 + MEASURE_TOLERANCE):
            findings.append(Finding(
                "cost", "error",
                f"{name}: kernel {kname} records {gbps} GB/s, above "
                f"the {peak_gbps} GB/s HBM peak — the bytes model or "
                f"the peak table is miscalibrated",
                op="measured-above-ceiling"))
        if frac and frac > 1 + MEASURE_TOLERANCE:
            findings.append(Finding(
                "cost", "error",
                f"{name}: kernel {kname} records roofline fraction "
                f"{frac} > 1 — impossible; the gate memory is "
                f"miscalibrated", op="measured-above-ceiling"))
    for kname, floor in (floors or {}).items():
        if floor > 1.0:
            findings.append(Finding(
                "cost", "error",
                f"published roofline-fraction floor {floor} for kernel "
                f"{kname} exceeds the cost-model ceiling (1.0) — no "
                f"measurement can ever pass it",
                op="floor-above-ceiling"))
    return findings


def audit_bench_artifact(doc: dict, name: str,
                         mfu_floors: Optional[Dict[str, float]] = None,
                         ) -> List[Finding]:
    """Physics audit of one BENCH document: measured MFU ≤ 1, HFU ≥
    MFU (hardware flops include rematerialization, never less than
    model flops), and published MFU floors under the ceiling."""
    findings: List[Finding] = []
    configs = (doc.get("configs")
               or (doc.get("parsed") or {}).get("configs") or {})
    for cname, rec in configs.items():
        if not isinstance(rec, dict):
            continue
        mfu, hfu = rec.get("mfu"), rec.get("hfu")
        if mfu and mfu > 1 + MEASURE_TOLERANCE:
            findings.append(Finding(
                "cost", "error",
                f"{name}: config {cname} records MFU {mfu} > 1 — "
                f"impossible; flops model miscalibrated",
                op="measured-above-ceiling"))
        # hfu is not None, not truthiness: a recorded hfu of exactly
        # 0.0 (broken hardware-flops counter) is the very case this
        # audit exists for
        if mfu and hfu is not None and hfu < mfu * (1 - MEASURE_TOLERANCE):
            findings.append(Finding(
                "cost", "error",
                f"{name}: config {cname} records HFU {hfu} below MFU "
                f"{mfu} — hardware flops can never undercut model "
                f"flops; one of the two counters is wrong",
                op="measured-above-ceiling"))
    for cname, floor in (mfu_floors or {}).items():
        if floor > 1.0:
            findings.append(Finding(
                "cost", "error",
                f"published MFU floor {floor} for config {cname} "
                f"exceeds the ceiling (1.0)",
                op="floor-above-ceiling"))
    return findings


def audit_floor_artifacts(search_dir: str,
                          kernel_floors: Optional[Dict[str, float]] = None,
                          mfu_floors: Optional[Dict[str, float]] = None,
                          ) -> List[Finding]:
    """Cross-check the newest committed ``KERNELBENCH_r*.json`` and
    ``BENCH_r*.json`` against the cost-model ceilings (see the module
    docstring).  Measurements in the artifacts are always audited;
    the published FLOOR tables are audited only when passed in —
    this module deliberately imports no benchmark, so callers supply
    their own tables."""
    findings: List[Finding] = []
    # the floor tables are artifact-INDEPENDENT physics: a published
    # floor above the ceiling must fail even when no artifact file
    # loads (a corrupt newest round must never launder an impossible
    # floor through a clean verdict)
    findings += audit_kernel_artifact({}, "published floors",
                                      floors=kernel_floors)
    findings += audit_bench_artifact({}, "published floors",
                                     mfu_floors=mfu_floors)
    kpath = next(iter(_rounds_desc(search_dir, "KERNELBENCH_r*.json")),
                 None)
    if kpath:
        doc = _load(kpath)
        if doc is not None:
            findings += audit_kernel_artifact(doc,
                                              os.path.basename(kpath))
        else:
            findings.append(Finding(
                "cost", "warning",
                f"{os.path.basename(kpath)} is unreadable — kernel "
                f"measurements NOT audited this round",
                op="roofline"))
    # newest BENCH round whose measured configs survived the artifact
    # wrapper (older rounds keep the parsed block; a truncated tail
    # records nothing auditable)
    bpath = None
    bench_rounds = _rounds_desc(search_dir, "BENCH_r*.json")
    for cand in bench_rounds:
        doc = _load(cand)
        if doc is None:
            continue
        if (doc.get("configs")
                or (doc.get("parsed") or {}).get("configs")):
            findings += audit_bench_artifact(doc,
                                             os.path.basename(cand))
            bpath = cand
            break
    if bench_rounds and bpath is None:
        findings.append(Finding(
            "cost", "warning",
            f"no readable BENCH_r*.json with measured configs (newest "
            f"{os.path.basename(bench_rounds[0])}) — MFU measurements "
            f"NOT audited this round", op="roofline"))
    if not findings:
        findings.append(Finding(
            "cost", "info",
            f"gate calibration audit: committed floors and "
            f"measurements sit under the cost-model ceilings "
            f"({os.path.basename(kpath) if kpath else 'no KERNELBENCH'}"
            f", {os.path.basename(bpath) if bpath else 'no BENCH'})",
            op="roofline"))
    return findings


register_pass("cost", cost_pass)
