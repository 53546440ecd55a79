"""The native worker pool (`bs_call_tpu_torch/native/bsc_pool.cpp`), built
on its own with a small C++ driver.

(a) Race: two submitter threads make back-to-back `pool_run` calls under
ThreadSanitizer. Each call's `Job` lives on its submitter's stack, so a
worker that touches a finished job after `pool_run` has returned races the
next call's `Job` at the same address; TSAN reports it even when the stale
write lands harmlessly, which a plain stress run would not notice.
(b) Semantics, plain -O2: every index runs once, a nested `pool_run` runs
inline on the worker that called it, and `n <= 1` runs on the caller."""

import os
import shutil
import subprocess

import pytest

POOL_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bs_call_tpu_torch", "native", "bsc_pool.cpp",
)

DRIVER = r"""
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace bsc {
void pool_run(int n, const std::function<void(int)> &fn);
}

static int race(long calls, double budget_s) {
    // Items of 9. The submitter's first item waits (up to 200 us) until a
    // worker has started one, and a worker's item runs a little longer,
    // so workers still finish items after the submitter has run out of
    // items to claim: the window in which a late worker can touch a
    // finished call's Job.
    const int n = 9;
    std::atomic<long> bad{0}, items{0}, done_calls{0};
    const auto t0 = std::chrono::steady_clock::now();
    auto submit = [&]() {
        for (long c = 0; c < calls; c++) {
            if ((c & 255) == 0 &&
                std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count() > budget_s)
                break;
            int hits[n];
            memset(hits, 0, sizeof(hits));
            std::atomic<int> others{0};
            const std::thread::id self = std::this_thread::get_id();
            bsc::pool_run(n, [&](int i) {
                if (std::this_thread::get_id() != self) {
                    others++;
                    for (volatile int k = 0; k < 1000; k++) {
                    }
                } else {
                    const auto w0 = std::chrono::steady_clock::now();
                    while (others.load() == 0 &&
                           std::chrono::steady_clock::now() - w0 <
                               std::chrono::microseconds(200)) {
                    }
                }
                __atomic_fetch_add(&hits[i], 1, __ATOMIC_RELAXED);
            });
            for (int i = 0; i < n; i++) {
                if (hits[i] != 1) bad++;
                items += hits[i];
            }
            done_calls++;
        }
    };
    std::thread a(submit), b(submit);
    a.join();
    b.join();
    printf("calls=%ld items=%ld bad=%ld\n", done_calls.load(), items.load(),
           bad.load());
    return bad.load() == 0 && items.load() == done_calls.load() * n ? 0 : 1;
}

static int semantics() {
    int fails = 0;
    auto check = [&](bool ok, const char *what) {
        if (!ok) {
            printf("FAIL %s\n", what);
            fails++;
        }
    };
    const std::thread::id caller = std::this_thread::get_id();
    // every index once, for several widths
    for (int n : {2, 3, 9, 17, 1000}) {
        std::vector<std::atomic<int>> hits(n);
        for (auto &h : hits) h = 0;
        bsc::pool_run(n, [&](int i) { hits[i]++; });
        bool once = true;
        for (auto &h : hits) once = once && h.load() == 1;
        check(once, "each index runs once");
    }
    // n <= 1: on the caller, or not at all
    int ran = 0;
    bool on_caller = true;
    bsc::pool_run(1, [&](int i) {
        ran++;
        on_caller = on_caller && i == 0 &&
                    std::this_thread::get_id() == caller;
    });
    check(ran == 1 && on_caller, "n == 1 runs once on the caller");
    ran = 0;
    bsc::pool_run(0, [&](int) { ran++; });
    bsc::pool_run(-3, [&](int) { ran++; });
    check(ran == 0, "n <= 0 runs nothing");
    // nested: the caller holds outer item 0 until a worker has taken
    // item 1, whose nested call must then run inline, on that worker and
    // in order, though the other workers sit idle to take queued items
    const int inner = 32;
    std::vector<std::atomic<int>> in_hits(inner);
    for (auto &h : in_hits) h = 0;
    std::atomic<int> on_worker{0}, not_inline{0};
    bsc::pool_run(2, [&](int) {
        const std::thread::id me = std::this_thread::get_id();
        if (me == caller) {
            const auto w0 = std::chrono::steady_clock::now();
            while (on_worker.load() == 0 &&
                   std::chrono::steady_clock::now() - w0 <
                       std::chrono::seconds(5)) {
            }
            return;
        }
        on_worker++;
        int next = 0;
        bsc::pool_run(inner, [&](int i) {
            in_hits[i]++;
            if (std::this_thread::get_id() != me || i != next) not_inline++;
            next = i + 1;
            std::this_thread::sleep_for(std::chrono::microseconds(100));
        });
    });
    bool once = true;
    for (auto &h : in_hits) once = once && h.load() == 1;
    check(on_worker.load() == 1, "a worker took an outer item");
    check(once, "each nested index runs once");
    check(not_inline.load() == 0, "a nested call on a worker runs inline");
    printf("semantics fails=%d\n", fails);
    return fails ? 1 : 0;
}

int main(int argc, char **argv) {
    if (argc > 1 && !strcmp(argv[1], "race"))
        return race(atol(argv[2]), atof(argv[3]));
    return semantics();
}
"""

# Calls a submitter makes in the race case, and the seconds it may take:
# a pool that counts an item before it locks the job to notify races in
# nearly every run of this count; the budget keeps a loaded run short.
RACE_CALLS = 4_000
RACE_BUDGET_S = 10


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the native pool")
    return gxx


def _build(tmp_path, name, flags):
    drv = tmp_path / "driver.cpp"
    drv.write_text(DRIVER)
    out = tmp_path / name
    res = subprocess.run(
        [_gxx(), *flags, "-pthread", "-o", str(out), str(drv), POOL_SRC],
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    return str(out)


def _tsan_or_skip(tmp_path):
    """Skip when this compiler cannot build and run a ThreadSanitizer
    program at all; the pool's own build is then asserted."""
    probe = tmp_path / "probe.cpp"
    probe.write_text("#include <thread>\n"
                     "int main(){std::thread t([]{});t.join();return 0;}\n")
    exe = tmp_path / "probe"
    res = subprocess.run(
        [_gxx(), "-fsanitize=thread", "-pthread", "-o", str(exe), str(probe)],
        capture_output=True, text=True, timeout=120,
    )
    if res.returncode != 0:
        pytest.skip("g++ cannot build with -fsanitize=thread: "
                    + res.stderr.strip()[-300:])
    res = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        pytest.skip("ThreadSanitizer's runtime does not start here: "
                    + res.stderr.strip()[-300:])


def test_pool_completion_has_no_race_under_tsan(tmp_path):
    _tsan_or_skip(tmp_path)
    exe = _build(tmp_path, "race", ["-O1", "-g", "-fsanitize=thread"])
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    res = subprocess.run(
        [exe, "race", str(RACE_CALLS), str(RACE_BUDGET_S)],
        capture_output=True, text=True, timeout=RACE_BUDGET_S + 10, env=env,
    )
    report = res.stdout + res.stderr
    assert "WARNING: ThreadSanitizer" not in report, report[-4000:]
    assert res.returncode == 0, report[-4000:]
    calls, items, bad = (int(f.split("=")[1])
                         for f in res.stdout.split()[-3:])
    assert bad == 0 and items == 9 * calls
    assert calls >= 500, report


def test_pool_semantics(tmp_path):
    exe = _build(tmp_path, "semantics", ["-O2"])
    res = subprocess.run([exe], capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "semantics fails=0" in res.stdout
