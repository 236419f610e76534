"""The benchmark's frozen generators against the port's."""

import numpy as np

from lingambench.lib import simulate
from repro_torch.data import simulate as port


def test_simulate_lingam_equals_the_ports():
    mine = simulate.simulate_lingam(300, 9, seed=2147483653)
    theirs = port.simulate_lingam(m=300, d=9, seed=2147483653)
    np.testing.assert_array_equal(mine[0], theirs.data)
    np.testing.assert_array_equal(mine[1], theirs.adjacency)
    np.testing.assert_array_equal(mine[2], theirs.order)


def test_simulate_var_stocks_equals_the_ports():
    mine = simulate.simulate_var_stocks(200, 12, edge_prob=0.2,
                                        seed=2147483653)
    theirs = port.simulate_var_stocks(m=200, d=12, edge_prob=0.2,
                                      seed=2147483653)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
