"""plan_prepare_ms: the planner's prep (parallel/fleet.py::FleetBatchPrep:
the snapshot, the plans and one full sizing on the card), the program's
own `profile["prepare_ms"]`, ms a call over the window."""


def read(ctx):
    return ctx["entry"].get("plan_prepare_ms")
