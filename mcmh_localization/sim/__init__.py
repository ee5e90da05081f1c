from mcmh_localization.sim.trajectory import (
    static_trajectory,
    straight_line_spin_trajectory,
    square_trajectory,
    l_rest_trajectory,
    fit_trajectory_to_map,
    second_placement,
    SCENARIOS,
)
from mcmh_localization.sim.simulator import simulate_bag, Bag
from mcmh_localization.sim.bag import save_bag, load_bag

__all__ = [
    "static_trajectory",
    "straight_line_spin_trajectory",
    "square_trajectory",
    "l_rest_trajectory",
    "fit_trajectory_to_map",
    "second_placement",
    "SCENARIOS",
    "simulate_bag",
    "Bag",
    "save_bag",
    "load_bag",
]
