"""Merge DNSMOS CSV scores into evaluation results JSON (port of
ditsep_tpu/eval/dnsmos.py, as it is: pure Python and numpy).

Reference: src/evaluate/merge_dnsmos.py:12-160. DNSMOS is computed
externally (Microsoft's ONNX models) over the separated wavs; this joins
its per-file CSV back into the per-utterance results JSON and refreshes
the summary JSON's means.
"""
from __future__ import annotations

import json
import re
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# default index parse: the digit run at the START of the stem — the
# naming this harness writes ("0012.enh0.wav" -> 12; evaluate.py
# save-samples). Anything else (e.g. "fs8000_0012.enh0") needs an
# explicit filename_index_re; unmatched rows warn instead of silently
# attaching scores to the wrong utterance.
_DEFAULT_INDEX_RE = r"^(\d+)"


def merge_dnsmos(results_json: str, dnsmos_csv: str,
                 out_json: Optional[str] = None,
                 filename_index_re: str = _DEFAULT_INDEX_RE) -> Dict:
    """Join DNSMOS columns (OVRL/SIG/BAK) into results keyed by utterance
    index parsed from the CSV's filename column; rewrites
    ``<split>_summary.json`` (when present next to the results) with the
    refreshed means including the new DNSMOS fields."""
    import csv

    with open(results_json) as f:
        results = json.load(f)

    scores: Dict[str, Dict[str, list]] = {}
    unmatched = 0
    with open(dnsmos_csv) as f:
        for row in csv.DictReader(f):
            fname = row.get("filename") or row.get("file") or ""
            m = re.search(filename_index_re, Path(fname).stem)
            if not m:
                unmatched += 1
                continue
            idx = str(int(m.group(1)))
            if idx not in results:
                unmatched += 1
                continue
            entry = scores.setdefault(
                idx, {"dnsmos_ovrl": [], "dnsmos_sig": [],
                      "dnsmos_bak": []})
            for src, dst in [("OVRL", "dnsmos_ovrl"), ("SIG", "dnsmos_sig"),
                             ("BAK", "dnsmos_bak")]:
                if src in row and row[src] != "":
                    entry[dst].append(float(row[src]))
    if unmatched:
        warnings.warn(
            f"merge_dnsmos: {unmatched} CSV row(s) matched no utterance "
            f"in {results_json} (index pattern {filename_index_re!r} on "
            "the filename stem)", stacklevel=2)

    for idx, entry in scores.items():
        for k, v in entry.items():
            if v:
                results[idx][k] = v

    out = out_json or results_json
    with open(out, "w") as f:
        json.dump(results, f, indent=0)
    _refresh_summary(out, results)
    return results


def _refresh_summary(results_path: str, results: Dict) -> None:
    """Recompute the mean-metrics summary next to the results file
    (the schema evaluate_dataset writes; reference: merge_dnsmos.py
    refreshes the same artifact)."""
    p = Path(results_path)
    summary_path = p.with_name(p.stem + "_summary.json")
    if not summary_path.exists():
        return
    summary = json.loads(summary_path.read_text())
    keys = set()
    for r in results.values():
        keys.update(k for k, v in r.items()
                    if isinstance(v, (int, float, list)))
    keys.discard("batch_idx")
    for k in sorted(keys):
        vals = []
        for r in results.values():
            v = r.get(k)
            if v is None:
                continue
            arr = np.asarray(v, np.float64).reshape(-1)
            if arr.size:
                vals.append(np.nanmean(arr))
        if vals:
            summary[k] = float(np.nanmean(np.asarray(vals)))
    summary["number"] = len(results)
    summary_path.write_text(json.dumps(summary, indent=1))
