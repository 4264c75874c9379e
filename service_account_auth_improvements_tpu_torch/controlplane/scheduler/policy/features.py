"""sched-journal/v1: the placement-row schema and its featurizer (the
port's own copy of ``controlplane/scheduler/policy/features.py``).

The scheduler journals every placement decision with the inventory state
as seen at decision time. A row carries :data:`PLACEMENT_FIELDS`;
:func:`check_row` asserts them, and :func:`encode_state` turns one
inventory state into the fixed-width example the scorer reads. The
reference's serving side (``serve.PolicyChooser``) encodes with the
reference's copy of that function; the port's tests hold the two copies
bit for bit equal, so a policy this trainer fits sees inference inputs
encoded exactly like its training set.

Feasibility mask: ``mask[i]`` is True iff the i-th pool (in sorted-name
order) is in the row's ``feasible`` list. A row whose chosen pool falls
outside its own mask is dropped, not learned from (it would teach the
policy to double-book).

The reference keeps numpy optional here, because every control-plane
binary imports its schema half. The port's copy serves only the trainer,
which needs numpy anyway, so it imports it outright.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

JOURNAL_SCHEMA = "sched-journal/v1"

#: fields every sched-journal/v1 placement row carries. ``scores`` rides
#: along only on learned decisions and ``fallback`` only on abstentions;
#: neither is required.
PLACEMENT_FIELDS = frozenset({
    "schema",          # JOURNAL_SCHEMA, the version pin itself
    "pool",            # chosen pool name (the decision)
    "chips",           # chips the demand charged
    "time_to_placement_s",  # admission-to-decision latency (the outcome)
    "free_chips",      # {pool: free chips at decision time}
    "total_chips",     # {pool: capacity}, the fragmentation denominator
    "feasible",        # [pool names], the shared feasibility mask
    "demand_chips",    # demand shape
    "demand_hosts",
    "slice_class",
    "queue_depth",     # backlog behind this decision
    "policy",          # "best_fit" | "learned" | "pinned"
})

#: optional typed riders (the parking vocabulary): type-checked when
#: present, never required
RIDER_FIELDS = {
    "park_reason": str,
    "resume_latency_ms": (int, float),
}

#: fixed model width: examples hold up to this many pools (sorted by
#: name). Features are per-pool blocks, so the scorer itself is
#: pool-count-agnostic up to the pad.
MAX_POOLS = 16
#: per-pool feature block: [free_norm, leftover_norm, occupancy]
POOL_FEATURES = 3
#: global features: [demand_chips_norm, demand_hosts_norm, queue_norm]
GLOBAL_FEATURES = 3


@dataclasses.dataclass(frozen=True)
class Example:
    """One training example (or one inference state, label < 0)."""

    pool_feats: np.ndarray   # (MAX_POOLS, POOL_FEATURES) float32
    glob: np.ndarray         # (GLOBAL_FEATURES,) float32
    mask: np.ndarray         # (MAX_POOLS,) bool, feasibility
    label: int               # chosen pool index, -1 at inference
    ttp_s: float             # outcome latency, 0.0 at inference
    pools: tuple             # pool-name order behind the indices


def check_row(attrs: dict) -> list[str]:
    """Missing or mis-typed required fields of one placement row (empty =
    valid)."""
    problems = []
    for field in sorted(PLACEMENT_FIELDS):
        if field not in attrs:
            problems.append(f"missing field {field!r}")
    if attrs.get("schema") not in (None, JOURNAL_SCHEMA):
        problems.append(
            f"schema {attrs.get('schema')!r} != {JOURNAL_SCHEMA!r}")
    for field in ("free_chips", "total_chips"):
        if field in attrs and not isinstance(attrs[field], dict):
            problems.append(f"{field} is not a mapping")
    if "feasible" in attrs and not isinstance(attrs["feasible"],
                                              (list, tuple)):
        problems.append("feasible is not a list")
    for rider, types in RIDER_FIELDS.items():
        if rider in attrs and not isinstance(attrs[rider], types):
            problems.append(f"rider {rider} is not {types}")
    return problems


def encode_state(free_chips: dict, total_chips: dict, feasible,
                 demand_chips: int, demand_hosts: int,
                 queue_depth: int) -> tuple | None:
    """(pool_feats, glob, mask, pools) for one inventory state, or None
    when the state does not fit the fixed width (no pools, or more than
    MAX_POOLS)."""
    pools = tuple(sorted(free_chips))
    if not pools or len(pools) > MAX_POOLS:
        return None
    scale = float(max((total_chips.get(p) or 0) for p in pools) or 1)
    feats = np.zeros((MAX_POOLS, POOL_FEATURES), dtype=np.float32)
    mask = np.zeros((MAX_POOLS,), dtype=bool)
    feasible_set = set(feasible)
    for i, name in enumerate(pools):
        free = float(free_chips.get(name) or 0)
        total = float(total_chips.get(name) or 0)
        feats[i, 0] = free / scale
        feats[i, 1] = (free - demand_chips) / scale
        feats[i, 2] = 1.0 - (free / total if total else 0.0)
        mask[i] = name in feasible_set
    glob = np.array([
        demand_chips / scale,
        min(int(demand_hosts), 16) / 16.0,
        min(int(queue_depth), 64) / 64.0,
    ], dtype=np.float32)
    return feats, glob, mask, pools


def example_from(entry: dict) -> Example | None:
    """Journal entry (or bare attrs dict) to Example, or None for rows
    the policy must not learn from: wrong kind or schema, too many pools,
    a chosen pool missing from the inventory, or a choice outside its own
    feasibility mask."""
    attrs = entry.get("attrs", entry)
    if entry.get("kind") not in (None, "placement"):
        return None
    if check_row(attrs):
        return None
    encoded = encode_state(
        attrs["free_chips"], attrs["total_chips"], attrs["feasible"],
        attrs["demand_chips"], attrs["demand_hosts"],
        attrs["queue_depth"],
    )
    if encoded is None:
        return None
    feats, glob, mask, pools = encoded
    try:
        label = pools.index(attrs["pool"])
    except ValueError:
        return None
    if not mask[label]:
        return None
    return Example(
        pool_feats=feats, glob=glob, mask=mask, label=label,
        ttp_s=float(attrs.get("time_to_placement_s") or 0.0),
        pools=pools,
    )


def placement_rows(entries) -> list[dict]:
    """The ``placement``-kind subset of a journal snapshot or JSONL load."""
    return [e for e in entries if e.get("kind") == "placement"]


def load_journal_jsonl(path: str) -> list[dict]:
    """Parse a journal JSONL dump (one entry per line) into entry dicts."""
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


def dataset(entries) -> dict:
    """Stack every usable placement row into training arrays:
    ``{"pool_feats": (N,P,F), "glob": (N,G), "mask": (N,P),
    "label": (N,), "ttp_s": (N,), "dropped": int}``. ``dropped`` counts
    the rows the featurizer refused, so callers can surface a harvest
    that silently thins."""
    examples = []
    dropped = 0
    for e in placement_rows(entries):
        ex = example_from(e)
        if ex is None:
            dropped += 1
        else:
            examples.append(ex)
    if not examples:
        return {
            "pool_feats": np.zeros((0, MAX_POOLS, POOL_FEATURES),
                                   np.float32),
            "glob": np.zeros((0, GLOBAL_FEATURES), np.float32),
            "mask": np.zeros((0, MAX_POOLS), bool),
            "label": np.zeros((0,), np.int32),
            "ttp_s": np.zeros((0,), np.float32),
            "dropped": dropped,
        }
    return {
        "pool_feats": np.stack([ex.pool_feats for ex in examples]),
        "glob": np.stack([ex.glob for ex in examples]),
        "mask": np.stack([ex.mask for ex in examples]),
        "label": np.array([ex.label for ex in examples], np.int32),
        "ttp_s": np.array([ex.ttp_s for ex in examples], np.float32),
        "dropped": dropped,
    }
