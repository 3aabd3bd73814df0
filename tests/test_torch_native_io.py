"""The port's native CSV reader (``csrc/csv_reader.cc``, built by
``native.load_csv_reader``) at its edges: the counterpart of
tests/test_native_io.py, whose five cases it runs against the port's own
copy of the source.

The counting pass and the parsing pass must agree exactly on what
constitutes a record: callers allocate from the count, and threads write
disjoint slices sized by per-span counts, so any disagreement is a heap
overflow. Each case reproduced such a mismatch in the JAX package's
reader before its predicate was unified."""

import ctypes

import numpy as np
import pytest

from safer2_recommender_tpu_torch import native


@pytest.fixture(scope="module")
def lib():
    lib = native.load_csv_reader()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def _read(lib, tmp_path, content):
    path = str(tmp_path / "t.csv")
    with open(path, "w") as f:
        f.write(content)
    n = lib.frt_csv_count(path.encode())
    u = np.zeros(max(n, 0), np.int32)
    i = np.zeros(max(n, 0), np.int32)
    got = lib.frt_csv_read(
        path.encode(),
        u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    return n, got, u, i


def test_trailing_whitespace_no_newline(lib, tmp_path):
    # trailing blanks must not parse as an extra record
    n, got, u, i = _read(lib, tmp_path, "uid,sid\n1,2\n3,4\n   ")
    assert (n, got) == (2, 2)
    assert list(u) == [1, 3] and list(i) == [2, 4]


def test_whitespace_only_line_skipped(lib, tmp_path):
    # no phantom (0, 0) interaction
    n, got, u, i = _read(lib, tmp_path, "uid,sid\n1,2\n \t \n3,4\n")
    assert (n, got) == (2, 2)
    assert list(u) == [1, 3]


def test_leading_space_fields(lib, tmp_path):
    # atoi-like whitespace skip inside fields
    n, got, u, i = _read(lib, tmp_path, "uid,sid\n 5, 7\n")
    assert (n, got) == (1, 1) and u[0] == 5 and i[0] == 7


def test_multithreaded_path_with_space_prefixed_line(lib, tmp_path):
    # >= 2^16 rows takes the threaded path; a space-prefixed line must be
    # counted as the parser writes it, inside its thread's slice
    rows = "\n".join((" " if k == 40000 else "") + f"{k % 97},{k % 31}"
                     for k in range(70000))
    n, got, u, i = _read(lib, tmp_path, "uid,sid\n" + rows + "\n")
    assert (n, got) == (70000, 70000)
    assert u[40000] == 40000 % 97 and u[69999] == 69999 % 97


def test_fuzz_against_python_reference(lib, tmp_path):
    # arbitrary mixes of CRLF, blank and whitespace-only lines, leading
    # spaces and a missing final newline parse to exactly what a Python
    # reference parse produces
    rng = np.random.default_rng(0)
    for trial in range(20):
        lines = ["uid,sid"]
        expect = []
        for _ in range(int(rng.integers(1, 200))):
            r = rng.random()
            if r < 0.1:
                lines.append("")
            elif r < 0.2:
                lines.append(" \t ")
            else:
                u, i = int(rng.integers(0, 5000)), int(rng.integers(0, 5000))
                pad = " " * int(rng.integers(0, 3))
                lines.append(f"{pad}{u},{pad}{i}")
                expect.append((u, i))
        sep = "\r\n" if trial % 3 == 0 else "\n"
        content = sep.join(lines)
        if trial % 2 == 0:
            content += sep
        n, got, u, i = _read(lib, tmp_path, content)
        assert n == got == len(expect), (trial, n, got, len(expect))
        assert list(zip(u.tolist(), i.tolist())) == expect, trial
