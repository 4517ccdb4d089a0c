"""The read contract of `<logdir>/metrics.jsonl` (a copy of the JAX
package's utils/metrics_io.py).

The train CLI appends to the file across restarts, so after a resume the
same step can appear twice: once from the run that was stopped and once
from the resumed run. On every resume the CLI appends a marker line
`{"resumed_at": <counter>}` before its first step line. `read_metrics`
skips the markers and keeps the last line of each step (the resumed
run's, the one the surviving checkpoints produced).
"""
from __future__ import annotations

import json
from typing import Dict, List


def _rows(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def read_metrics(path: str) -> List[Dict]:
    """The step rows of a metrics.jsonl file, the last line of each step,
    sorted by step; lines without a `step` key (the resume markers) are
    skipped."""
    by_step: Dict[int, Dict] = {}
    for row in _rows(path):
        if 'step' in row:
            by_step[row['step']] = row
    return [by_step[s] for s in sorted(by_step)]


def read_resume_markers(path: str) -> List[int]:
    """The counters at which the run was resumed, one per restart."""
    return [row['resumed_at'] for row in _rows(path) if 'resumed_at' in row]
