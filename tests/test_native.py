"""Native C++ library: cell-list parity vs NumPy, cfg-row formatter."""

import numpy as np
import pytest

from mtp_jax.utils import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_cell_list_matches_bruteforce(rng):
    n, L = 300, 18.0
    cell = np.array([[L, 0, 0], [1.5, L, 0], [0.5, -1.0, L]])
    pos = rng.uniform(0, L, (n, 3))
    cutoff = 4.0
    idx, counts, ovf = native.cell_list_host(pos, cell, cutoff, 64)
    assert not ovf

    inv = np.linalg.inv(cell)
    f = pos @ inv
    df = f[None] - f[:, None]
    df -= np.round(df)
    disp = df @ cell
    d2 = np.einsum("ija,ija->ij", disp, disp)
    np.fill_diagonal(d2, np.inf)
    keep = d2 <= cutoff**2
    for i in range(n):
        assert set(int(j) for j in idx[i] if j != i) == set(
            np.nonzero(keep[i])[0].tolist()
        )
    np.testing.assert_array_equal(counts, keep.sum(axis=1))


def test_cell_list_overflow_flag(rng):
    pos = rng.uniform(0, 10.0, (100, 3))
    _, counts, ovf = native.cell_list_host(pos, np.eye(3) * 10.0, 4.0, 2)
    assert ovf and counts.max() > 2


def test_format_cfg_atoms_matches_python(rng):
    pos = rng.uniform(0, 5, (7, 3))
    types = rng.integers(0, 2, 7).astype(np.int32)
    grades = rng.uniform(0, 3, 7)
    s = native.format_cfg_atoms(pos, types, grades)
    lines = s.strip().split("\n")
    assert len(lines) == 7
    first = lines[0].split("\t")
    assert first[0] == "1"
    assert int(first[1]) == types[0]
    assert float(first[2]) == pytest.approx(pos[0, 0], abs=1e-6)
    assert float(first[5]) == pytest.approx(grades[0], abs=1e-5)

    # matches the pure-python fallback exactly
    lib = native._lib
    try:
        native._lib = None
        s_py = native.format_cfg_atoms(pos, types, grades)
    finally:
        native._lib = lib
    assert s == s_py
