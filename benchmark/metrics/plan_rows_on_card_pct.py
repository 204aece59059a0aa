"""plan_rows_on_card_pct: the share of the planner's rows solved on the card
(`ops/csrc/plan_rows_kernel.cu`) and not in host numpy, from the program's
`plan_card_rows` and `plan_host_rows` counters over the traced window, %.
Nothing to read in a program that counts neither."""


def read(ctx):
    c = ctx["counters"]
    card, host = c.get("plan_card_rows", 0), c.get("plan_host_rows", 0)
    return 100.0 * card / (card + host) if card + host else None
