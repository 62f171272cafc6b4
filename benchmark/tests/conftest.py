"""Tests of the benchmark's pieces on the CPU at tiny shapes."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# tiny versions of each cell: the same files with their sizes cut
TINY = {
    "offline.library_rows": {"traffic": {"tracks": 3, "track_s": 4, "valid_s": [3, 4],
                                         "check_tracks": 2, "warmup_steps": 1}},
}
