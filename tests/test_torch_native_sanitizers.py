"""Sanitizer runs of the port's threaded native CSV reader
(``csrc/csv_reader.cc``, ``native.CSV_READER_SRC``): the counterpart of
tests/test_native_sanitizers.py.

The reader is the port's only threaded native code (std::thread workers
parsing disjoint spans of a shared mmap). Each case compiles it with
ThreadSanitizer, AddressSanitizer + UBSan, or strict UBSan into a
standalone test binary (sanitizer runtimes do not come up inside an
uninstrumented Python through dlopen) and pushes the threaded corpus
through it: a data race, a heap overflow or undefined behaviour ends the
run non-zero."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from safer2_recommender_tpu_torch import native

pytestmark = pytest.mark.slow

_MAIN = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
extern "C" {
int64_t frt_csv_count(const char*);
int64_t frt_csv_read(const char*, int32_t*, int32_t*, int64_t);
}
int main(int argc, char** argv) {
  for (int a = 1; a < argc; ++a) {
    int64_t n = frt_csv_count(argv[a]);
    if (n < 0) return 2;
    std::vector<int32_t> u(n ? n : 1), v(n ? n : 1);
    int64_t got = frt_csv_read(argv[a], u.data(), v.data(), n);
    if (got != n) return 3;
  }
  std::printf("ok\n");
  return 0;
}
"""


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable")


def _corpus(tmp_path):
    """A corpus that takes the threaded path (>= 2^16 rows), plus the
    edge cases of tests/test_torch_native_io.py."""
    paths = []
    rows = "\n".join((" " if k == 40000 else "") + f"{k % 97},{k % 31}"
                     for k in range(80000))
    big = tmp_path / "big.csv"
    big.write_text("uid,sid\n" + rows + "\n")
    paths.append(str(big))

    rng = np.random.default_rng(1)
    lines = ["uid,sid"]
    for _ in range(500):
        r = rng.random()
        if r < 0.1:
            lines.append("")
        elif r < 0.2:
            lines.append(" \t ")
        else:
            lines.append(f"{rng.integers(0, 5000)},{rng.integers(0, 5000)}")
    messy = tmp_path / "messy.csv"
    messy.write_text("\r\n".join(lines))   # no trailing newline
    paths.append(str(messy))
    return paths


def _run_sanitized(tmp_path, flags, name):
    main = tmp_path / "main.cc"
    main.write_text(_MAIN)
    exe = tmp_path / f"drv_{name}"
    cmd = ["g++", "-O1", "-g", "-std=c++17", *flags,
           str(main), native.CSV_READER_SRC, "-o", str(exe), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, timeout=300)
    if res.returncode != 0:
        pytest.skip(f"{name} unavailable: {res.stderr.decode()[:200]}")
    run = subprocess.run([str(exe), *_corpus(tmp_path)],
                         capture_output=True, timeout=300,
                         env={**os.environ,
                              f"{name.upper()}_OPTIONS": "exitcode=66"})
    err = run.stderr.decode()
    assert run.returncode == 0, (run.returncode, err[:2000])
    assert "ok" in run.stdout.decode()
    assert "SUMMARY:" not in err, err[:2000]


def test_csv_reader_tsan(gxx, tmp_path):
    _run_sanitized(tmp_path, ["-fsanitize=thread"], "tsan")


def test_csv_reader_asan_ubsan(gxx, tmp_path):
    _run_sanitized(tmp_path, ["-fsanitize=address,undefined"], "asan")


def test_csv_reader_ubsan_full_strict(gxx, tmp_path):
    # UBSan with every non-default check on and recovery off: a
    # float-cast overflow, strict-bounds overrun or division by zero in
    # the parser aborts instead of printing and going on
    _run_sanitized(
        tmp_path,
        ["-fsanitize=undefined,float-divide-by-zero,float-cast-overflow,"
         "bounds-strict", "-fno-sanitize-recover=all"],
        "ubsan")
