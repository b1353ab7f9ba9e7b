"""Task-based evaluation (multiple-choice + greedy-match QA); see
tasks.py for the JSONL schema."""

from .tasks import (  # noqa: F401
    TaskExample,
    greedy_continuations,
    load_task_file,
    run_tasks,
    score_greedy_match,
    score_multiple_choice,
)
