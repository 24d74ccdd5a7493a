"""PROFILE_DRIFT documents: the schema of a continuous-profile drift
record and the ONE drift-sentinel rule, as
``apex_tpu/analysis/profile_drift.py`` (the port's own copy, stdlib
only; the functions are the JAX package's, line for line).

A continuous-profiling session over the serve engine writes one: bounded
capture windows parsed through :mod:`apex_tpu_torch.obs.xplane`,
bucketed through the step classifiers (:mod:`apex_tpu_torch.obs.
stepclass`), judged online by the :class:`~apex_tpu_torch.obs.contprof.
DriftSentinel`, with TWO lanes: a **clean** session the sentinel must
stay quiet on, and a **seeded-regression** session (a documented
synthetic op-time inflation of one bucket) the sentinel must catch,
naming the drifting bucket, in exactly ``k`` windows.

The sentinel rule lives HERE, as pure stdlib functions, because the
schema must RE-DERIVE every verdict from the recorded windows: a quiet
verdict over a recorded window sequence that derives a confirmed drift
is a CONTRADICTORY record and schema-invalid.  The online sentinel
(:mod:`apex_tpu_torch.obs.contprof`) imports these functions instead of
carrying a second copy, so the live tripwire and the validator can never
disagree:

- :func:`out_of_band` — one window vs the baseline under the statistical
  band rule (:data:`DEFAULT_BAND` 0.03 fallback; a recorded
  variance-derived width always wins): a bucket FRACTION is out when it
  moved more than ``band`` in absolute terms (fractions near zero make
  relative bands meaningless), the step WALL is out when it sits above
  ``baseline × (1 + band)`` (slower only — faster is not a regression);
- :func:`replay_sentinel` — the K-consecutive confirmation machine: a
  drift is confirmed only after ``k`` consecutive out-of-band windows
  (never a single noisy one), latches until a fully in-band window, and
  names the drifting bucket (the excursion present in all ``k`` windows
  with the largest mean |delta|; ties break by name).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

#: default statistical band width (the JAX package's fallback); a
#: recorded variance-derived width always overrides it.
DEFAULT_BAND = 0.03

#: the decode bucket vocabulary — MUST equal
#: :data:`apex_tpu_torch.obs.stepclass.DECODE_BUCKETS` and the JAX
#: package's tuples (duplicated so that this module stays stdlib only;
#: ``tests/test_torch_contprof.py`` pins the tuples equal).
DECODE_BUCKETS = ("param_read", "kv_read", "kv_write", "attention",
                  "sampling", "host_sync", "other")

#: the pinned train-step vocabulary — MUST equal
#: :data:`apex_tpu_torch.obs.stepclass.TRAIN_BUCKETS` (same
#: arrangement).
TRAIN_BUCKETS = ("fwd", "bwd", "optimizer", "collectives", "host_gap",
                 "other")

#: profile kinds and the bucket vocabulary each one buckets into
KINDS = {"decode": DECODE_BUCKETS, "serve-decode": DECODE_BUCKETS,
         "train": TRAIN_BUCKETS}


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


# ---------------------------------------------------------------------------
# the sentinel rule (imported by apex_tpu_torch.obs.contprof — one copy)
# ---------------------------------------------------------------------------

def out_of_band(fractions: Dict[str, float],
                step_wall_s: Optional[float],
                baseline: dict, band: float) -> List[dict]:
    """Excursions of one window against the baseline: ``[{"metric",
    "value", "baseline", "delta"}, ...]`` sorted by metric name.  A
    bucket fraction is out when ``|frac − base| > band`` (absolute
    move); the step wall is out when ``wall > base × (1 + band)``
    (``delta`` records the relative excess).  Judged on the RECORDED
    (rounded) numbers, so the validator re-derives exactly what the
    sentinel saw."""
    out: List[dict] = []
    base_fr = baseline.get("fractions") or {}
    for bucket in sorted(set(base_fr) | set(fractions or {})):
        f, bf = (fractions or {}).get(bucket), base_fr.get(bucket)
        if not (_num(f) and _num(bf)):
            continue
        delta = round(float(f) - float(bf), 4)
        if abs(delta) > band:
            out.append({"metric": bucket, "value": f, "baseline": bf,
                        "delta": delta})
    bw = baseline.get("step_wall_s")
    if _num(step_wall_s) and _num(bw) and bw > 0 \
            and step_wall_s > bw * (1.0 + band):
        out.append({"metric": "step_wall", "value": step_wall_s,
                    "baseline": bw,
                    "delta": round(step_wall_s / bw - 1.0, 4)})
    return out


def confirm_bucket(excursion_lists: List[List[dict]]) -> str:
    """The drifting bucket of a confirmed run of out-of-band windows:
    prefer metrics present in EVERY window of the run, rank by mean
    |delta| over the windows where the metric appears, break ties by
    name.  Deterministic — the validator re-derives it."""
    per_metric: Dict[str, List[float]] = {}
    for exc in excursion_lists:
        for e in exc:
            per_metric.setdefault(e["metric"], []).append(
                abs(float(e["delta"])))
    in_all = [m for m, ds in per_metric.items()
              if len(ds) == len(excursion_lists)]
    pool = in_all if in_all else list(per_metric)
    return min(pool,
               key=lambda m: (-sum(per_metric[m]) / len(per_metric[m]),
                              m))


def replay_sentinel(windows: List[dict], baseline: dict, band: float,
                    k: int) -> List[dict]:
    """Run the K-consecutive confirmation machine over recorded
    windows; returns the confirmed drifts ``[{"window", "bucket",
    "windows_out"}, ...]`` the sentinel must have produced.  A drift
    confirms at the ``k``-th consecutive out-of-band window, then
    LATCHES (no re-confirmation) until a fully in-band window resets
    the machine."""
    drifts: List[dict] = []
    run: List[List[dict]] = []
    active = False
    for w in windows:
        exc = out_of_band(w.get("fractions") or {},
                          w.get("step_wall_s"), baseline, band)
        if not exc:
            run = []
            active = False
            continue
        run.append(exc)
        if not active and len(run) >= k:
            drifts.append({"window": w.get("index"),
                           "bucket": confirm_bucket(run[-k:]),
                           "windows_out": len(run)})
            active = True
    return drifts


# ---------------------------------------------------------------------------
# schema validation
# ---------------------------------------------------------------------------

def _check_session(name: str, sess, band: float, k: int,
                   buckets, problems: List[str]) -> None:
    if not isinstance(sess, dict):
        problems.append(f"sessions[{name}] is not an object")
        return
    base = sess.get("baseline")
    if not isinstance(base, dict) or \
            not isinstance(base.get("fractions"), dict) or \
            not isinstance(base.get("source"), str):
        problems.append(f"sessions[{name}].baseline needs a 'source' "
                        f"str and a 'fractions' object")
        return
    bf = base["fractions"]
    unknown = [b for b in bf if b not in buckets]
    if unknown:
        problems.append(
            f"sessions[{name}].baseline carries unknown buckets "
            f"{sorted(unknown)} — one pinned vocabulary per kind")
    s = sum(float(v) for v in bf.values() if _num(v))
    if not 0.9 <= s <= 1.1:
        problems.append(f"sessions[{name}].baseline fractions sum to "
                        f"{s:.4f}, expected ~1")

    windows = sess.get("windows")
    if not isinstance(windows, list) or not windows:
        problems.append(f"sessions[{name}].windows missing/empty — a "
                        f"session with no captures judges nothing")
        return
    last = None
    for i, w in enumerate(windows):
        if not isinstance(w, dict) or \
                not isinstance(w.get("index"), int) or \
                not isinstance(w.get("fractions"), dict):
            problems.append(f"sessions[{name}].windows[{i}] needs an "
                            f"int index and a fractions object")
            return
        if last is not None and w["index"] <= last:
            problems.append(f"sessions[{name}].windows not strictly "
                            f"index-ascending at position {i}")
            return
        last = w["index"]
        wu = [b for b in w["fractions"] if b not in buckets]
        if wu:
            problems.append(
                f"sessions[{name}].windows[{i}] carries unknown "
                f"buckets {sorted(wu)}")
        # -- the recorded excursions must re-derive from the window's
        # own recorded fractions and the stated band (a window marked
        # in-band while its numbers sit out of band is the lie the
        # whole schema exists to reject)
        derived = out_of_band(w["fractions"], w.get("step_wall_s"),
                              base, band)
        stated = w.get("out_of_band")
        if not isinstance(stated, list):
            problems.append(f"sessions[{name}].windows[{i}] missing "
                            f"'out_of_band' list (empty = in-band)")
            continue
        dm = [e["metric"] for e in derived]
        stated_sorted = sorted(
            [e for e in stated if isinstance(e, dict)],
            key=lambda e: str(e.get("metric")))
        sm = [e.get("metric") for e in stated_sorted]
        if dm != sorted_metrics(sm):
            problems.append(
                f"CONTRADICTORY record: sessions[{name}].windows[{i}]"
                f" states out_of_band metrics {sm} but its recorded "
                f"fractions derive {dm} under band {band}")
            continue
        # names agree — the NUMBERS must re-derive too: an excursion
        # naming the right metric but carrying invented value/
        # baseline/delta fields (a dramatized drift, a minimized one)
        # is the same fabrication class
        for d_e, s_e in zip(derived, stated_sorted):
            bad = [f for f in ("value", "baseline", "delta")
                   if not _num(s_e.get(f))
                   or abs(float(s_e[f]) - float(d_e[f])) > 1e-9]
            if bad:
                problems.append(
                    f"CONTRADICTORY record: sessions[{name}]"
                    f".windows[{i}] out_of_band "
                    f"[{d_e['metric']!r}] states "
                    f"{ {f: s_e.get(f) for f in bad} } but "
                    f"re-deriving from the recorded fractions gives "
                    f"{ {f: d_e[f] for f in bad} }")
                break

    # -- verdicts must replay: the K-consecutive machine over the
    # recorded windows IS the ground truth
    derived_drifts = replay_sentinel(windows, base, band, k)
    stated_drifts = sess.get("drifts")
    if not isinstance(stated_drifts, list):
        problems.append(f"sessions[{name}] missing 'drifts' list "
                        f"(empty is fine — absent asserts nothing)")
        stated_drifts = []
    d_pairs = [(d["window"], d["bucket"]) for d in derived_drifts]
    s_pairs = [(d.get("window"), d.get("bucket"))
               for d in stated_drifts if isinstance(d, dict)]
    if d_pairs != s_pairs:
        problems.append(
            f"CONTRADICTORY record: sessions[{name}].drifts states "
            f"{s_pairs} but replaying the sentinel over the recorded "
            f"windows (band {band}, k {k}) derives {d_pairs} — a "
            f"quiet verdict over out-of-band windows (or an invented "
            f"drift) is invalid")
    quiet = sess.get("quiet")
    if not isinstance(quiet, bool):
        problems.append(f"sessions[{name}] missing bool 'quiet'")
    elif quiet != (len(stated_drifts) == 0):
        problems.append(
            f"CONTRADICTORY record: sessions[{name}].quiet={quiet} "
            f"but the session records {len(stated_drifts)} drift(s)")


def sorted_metrics(metrics: List[str]) -> List[str]:
    """Stated excursion metrics, normalized for comparison (the
    derivation emits them sorted by name)."""
    return sorted(m for m in metrics if isinstance(m, str))


def validate_profile_drift(doc) -> List[str]:
    """Problems with one parsed PROFILE_DRIFT document (empty =
    valid)."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    if not isinstance(doc.get("round"), int):
        problems.append("missing/invalid 'round' (int)")
    if not isinstance(doc.get("platform"), str):
        problems.append("missing/invalid 'platform' (str)")
    kind = doc.get("kind")
    if kind not in KINDS:
        problems.append(f"missing/unknown 'kind' {kind!r} (one of "
                        f"{sorted(KINDS)})")
        return problems
    buckets = KINDS[kind]

    band_rec = doc.get("band")
    if not isinstance(band_rec, dict) or not _num(band_rec.get("value")) \
            or not 0.0 < band_rec["value"] < 1.0 \
            or not isinstance(band_rec.get("source"), str):
        problems.append("missing/invalid 'band' (object with a "
                        "'value' in (0,1) and a 'source' str)")
        return problems
    band = float(band_rec["value"])
    k = doc.get("k")
    if not (isinstance(k, int) and k >= 1):
        problems.append("missing/invalid 'k' (int >= 1) — the "
                        "consecutive-window confirmation count")
        return problems
    if k < 2:
        problems.append("k must be >= 2: a sentinel confirming on a "
                        "single window alarms on every noisy capture")

    sessions = doc.get("sessions")
    if not isinstance(sessions, dict) or not sessions:
        problems.append("missing/empty 'sessions' map")
        return problems
    for name, sess in sorted(sessions.items()):
        _check_session(name, sess, band, k, buckets, problems)

    # -- the two mandatory lanes + the gate that re-derives from them
    clean = sessions.get("clean")
    seeded = sessions.get("seeded")
    if not isinstance(clean, dict):
        problems.append("missing 'clean' session — the sentinel must "
                        "demonstrably stay quiet on an undisturbed run")
    if not isinstance(seeded, dict):
        problems.append("missing 'seeded' session — the sentinel must "
                        "demonstrably catch a seeded regression")
    else:
        seed = seeded.get("seed")
        if not isinstance(seed, dict) or seed.get("bucket") not in \
                buckets or not _num(seed.get("factor")):
            problems.append("'seeded' session missing 'seed' "
                            "(bucket + factor) — an undocumented "
                            "synthetic regression is indistinguishable "
                            "from a fabricated catch")
        else:
            drifts = seeded.get("drifts") or []
            first = drifts[0] if drifts and isinstance(drifts[0], dict) \
                else {}
            if first.get("bucket") != seed["bucket"]:
                problems.append(
                    f"CONTRADICTORY record: the seeded session "
                    f"inflated bucket {seed['bucket']!r} but the "
                    f"first confirmed drift names "
                    f"{first.get('bucket')!r} — the sentinel must "
                    f"name the bucket that actually drifted")

    gate = doc.get("gate")
    if not isinstance(gate, dict) or \
            not isinstance(gate.get("clean_quiet"), bool) or \
            not isinstance(gate.get("seeded_caught"), bool) or \
            not isinstance(gate.get("ok"), bool):
        problems.append("missing/invalid 'gate' (clean_quiet + "
                        "seeded_caught + ok bools)")
    elif isinstance(clean, dict) and isinstance(seeded, dict):
        d_clean = clean.get("quiet") is True
        d_caught = bool(seeded.get("drifts"))
        if gate["clean_quiet"] != d_clean:
            problems.append(
                f"CONTRADICTORY verdict: gate.clean_quiet="
                f"{gate['clean_quiet']} but the clean session derives "
                f"{d_clean}")
        if gate["seeded_caught"] != d_caught:
            problems.append(
                f"CONTRADICTORY verdict: gate.seeded_caught="
                f"{gate['seeded_caught']} but the seeded session "
                f"derives {d_caught}")
        if gate["ok"] != (d_clean and d_caught):
            problems.append(
                f"CONTRADICTORY verdict: gate.ok={gate['ok']} but the "
                f"sessions derive {d_clean and d_caught}")

    if not (isinstance(doc.get("note"), str) and doc["note"].strip()):
        problems.append("missing/empty 'note' (str)")
    return problems


def validate_profile_drift_file(path: str) -> List[str]:
    """Problems with one PROFILE_DRIFT_r*.json file (empty = valid)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable profile-drift JSON: {e}"]
    return validate_profile_drift(doc)
