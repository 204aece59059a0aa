"""The planner cell's judge of a pick (`reference.rows.cells_off`) on a
case read on the card: a variant on v5e-8 at 2 replicas (19.2 cents an
hour) whose v5e-4 lane at 16 replicas and v5e-8 lane at 9 replicas have
the same objective, 67.2, in exact arithmetic. The reference's float64
orders that tie by cost; the program's float32 costs order it the other
way, and either pick is right. A pick that loses by a real difference is
still off."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference import rows

TIE = 1e-6
BOUNDARY = 1e-4


def _case():
    fleet = {"shape_names": ["v5e-4", "v5e-8", "v5e-16"], "cur_rank": np.array([1])}
    state = {"cur_reps": np.array([2]), "cur_cost": np.array([19.2])}
    d = {"feasible": np.array([[True, True, False]]),
         "rate": np.array([[24.94378467189956, 43.86596190669438, 1.0]]),
         "cpr": np.array([[4.8, 9.6, 19.2]]),
         "zero": np.zeros((1, 3), bool)}
    rates = np.array([[384.8936986846542 * 60.0]])  # req/min, one row
    return fleet, state, d, rates


@pytest.mark.parametrize("pick, tie, off", [
    ((0, 16), TIE, 0),  # the exact least: the tie ordered by cost
    ((1, 9), TIE, 0),  # the tie ordered by float32 rounding
    ((1, 10), TIE, 1),  # a replica too many: a real loss
    ((0, 15), TIE, 1),  # a replica too few for the load
    ((2, 4), TIE, 1),  # a shape not feasible
])
def test_exact_ties_either_way_and_losses_off(pick, tie, off):
    fleet, state, d, rates = _case()
    choice, reps = np.array([[pick[0]]]), np.array([[pick[1]]])
    assert rows.cells_off(fleet, state, d, rates, choice, reps, BOUNDARY, tie) == off


def test_the_reference_orders_the_tie_by_cost():
    """The case is a tie: the reference's own least is the cheaper lane,
    at an objective equal to the other's."""
    fleet, state, d, rates = _case()
    low, _ = rows.options(d, rates, 0.0)
    shape, reps = rows.pick(fleet, state, d, low)
    value, cost = rows._keys(fleet, state, d, np.array([[[16.0, 9.0, 1.0]]]))
    assert (int(shape[0, 0]), int(reps[0, 0])) == (0, 16)
    assert value[0, 0, 0] == pytest.approx(value[0, 0, 1], abs=1e-9)
    assert cost[0, 0, 0] < cost[0, 0, 1]


def test_equal_costs_still_go_by_shape_name():
    """Two lanes of equal cost (2 x v5e-4 and 1 x v5e-8) tie at every
    precision: the shape name decides, and the other pick is off."""
    fleet, state, d, _ = _case()
    fleet["cur_rank"] = np.array([2])
    state = {"cur_reps": np.array([1]), "cur_cost": np.array([19.2])}
    d["rate"] = np.array([[10.0, 20.0, 1.0]])
    rates = np.array([[15.0 * 60.0]])  # 2 x v5e-4 or 1 x v5e-8
    # sorted by name v5e-16 < v5e-4 < v5e-8: v5e-4 goes first
    on = rows.cells_off(fleet, state, d, rates, np.array([[0]]), np.array([[2]]), BOUNDARY, TIE)
    no = rows.cells_off(fleet, state, d, rates, np.array([[1]]), np.array([[1]]), BOUNDARY, TIE)
    assert (on, no) == (0, 1)
