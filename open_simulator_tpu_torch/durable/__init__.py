"""Durable runs: journaled checkpoint/resume + watchdog-guarded execution.

`journal` is the per-run write-ahead log (JSONL, fsync per record) that
lets a crashed or killed capacity sweep resume from its committed trials;
`checkpoint` snapshots the carry of a long commit scan between chunks;
`watchdog` puts hard deadlines around backend acquisition and blocking
device calls. Nothing here degrades to another device: a call that fails
or outlives its deadline is journaled and its error reaches the caller.
"""

from .checkpoint import (  # noqa: F401
    CheckpointError,
    PlanCheckpointer,
    active_checkpointer,
    checkpoint_every,
)
from .journal import (  # noqa: F401
    JournalError,
    RunJournal,
    atomic_write,
    completed_segments,
    default_runs_root,
    list_runs,
    replay,
    summarize_run,
)
from .watchdog import (  # noqa: F401
    DeadlineExceeded,
    acquire_backend,
    backend_deadline_s,
    call_deadline_s,
    guarded_call,
)
