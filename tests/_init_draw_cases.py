"""Starting states and shapes of numpy's global generator for the tests of
the init draw on the card (``ops/init_draw.py``): the plain twin's on the
CPU (``test_torch_init_draw.py``) and the kernels' (``test_torch_cuda.py``).
Each start leaves numpy's global state where a draw begins."""

import numpy as np


def _seeded(seed):
    np.random.seed(seed)


def _at_pos(pos):
    """Seeded, then the read position moved inside the block: attempts
    start at word offsets pos mod 4, and from 621 on run into the next
    block."""
    np.random.seed(5)
    state = list(np.random.get_state())
    state[2] = pos
    np.random.set_state(tuple(state))


def _cached():
    """A Gaussian cached by an odd draw: the next draw starts with it."""
    np.random.seed(9)
    np.random.normal(size=3)


#: a state seeded from the OS's entropy, once per process
_ENTROPY_STATE = np.random.RandomState().get_state()


def _unseeded():
    """``random_state`` None or 0: numpy's state as it stands, here one
    seeded from the OS's entropy (the same one for every draw of a
    comparison)."""
    np.random.set_state(_ENTROPY_STATE)


STARTS = {
    "seeded": lambda: _seeded(3121000102),
    "seeded_1": lambda: _seeded(1),
    "seeded_11": lambda: _seeded(11),
    "fresh_block": lambda: _at_pos(0),
    "mid_block": lambda: _at_pos(333),
    "straddle": lambda: _at_pos(622),
    "last_word": lambda: _at_pos(623),
    "cached": _cached,
    "unseeded": _unseeded,
}

#: (start, shape, blocks per segment): even, odd and one-row counts, at the
#: kernels' segment length and at segments shrunk to one or two blocks so
#: that a small draw spans many of them
CASES = [
    ("seeded", (100, 37), 420),
    ("seeded_1", (101, 37), 420),
    ("seeded", (1, 999), 420),
    ("seeded", (150, 151), 1),
    ("fresh_block", (50, 51), 1),
    ("mid_block", (100, 101), 2),
    ("straddle", (64, 65), 1),
    ("last_word", (64, 64), 1),
    ("cached", (50, 50), 1),
    ("cached", (51, 50), 2),
    ("cached", (1, 1), 1),
    ("unseeded", (120, 121), 1),
    ("unseeded", (7, 3), 420),
]


def state_after():
    """numpy's state and its next uniform draw (which moves the state)."""
    name, key, pos, has_gauss, gauss = np.random.get_state()
    return key.copy(), pos, has_gauss, gauss, np.random.random()


def same_state(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and a[1:] == b[1:]
