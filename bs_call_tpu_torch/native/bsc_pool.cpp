// Persistent shared worker pool for every parallel section in the
// native library.
//
// Why this exists: the parallel sections (pileup ranges, f64 model
// ranges, row formatting, BGZF inflate/deflate batches, align
// processing) used to spawn std::threads per call. At ~600 blocks per
// contig and up to 6 parallel sections per block, that is thousands of
// clone()+stack-mmap+munmap cycles per run; every stack munmap
// broadcasts TLB-shootdown IPIs, which under a hypervisor with CPU
// steal turns into multi-second kernel time (measured: 15s sys on a
// 4-core VM where the pooled run spends <2s). The reference keeps
// long-lived threads for exactly this reason (process.c:167-170,
// call_genotypes.c:124-138); this pool is the TPU-host analogue, one
// shared pool rather than per-subsystem thread classes.
//
// Semantics: pool_run(n, fn) executes fn(0..n-1), caller participates,
// returns when all n are done. Concurrent pool_run calls from
// different Python threads interleave their items on the same workers.
// Nested calls (fn itself calling pool_run) run inline — no deadlock.
// The Job lives on the submitter's stack, and a worker touches it only
// while holding j.m after its last item, so run returning means that
// no worker holds it.
// Fork safety: an atfork child handler abandons the parent's workers
// and re-creates the pool lazily (shard workers fork via
// multiprocessing on some platforms).

#include <malloc.h>
#include <pthread.h>
#include <sched.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace bsc {

int pool_size();  // declared in bsc_common.h too; definition below

namespace {

// `done` is guarded by `m`: counting an item and waking the submitter
// are one locked step, after which the worker reads nothing of the Job.
struct Job {
    const std::function<void(int)> *fn;
    std::atomic<int> next{0};
    int n = 0;
    int done = 0;
    std::mutex m;
    std::condition_variable cv;
};

thread_local bool in_worker = false;

class Pool {
  public:
    explicit Pool(int nworkers) {
        workers_.reserve(nworkers);
        for (int i = 0; i < nworkers; i++) {
            workers_.emplace_back([this]() { worker(); });
#ifdef __linux__
            char nm[16];
            snprintf(nm, sizeof(nm), "bsc-pool-%d", i);
            pthread_setname_np(workers_.back().native_handle(), nm);
#endif
        }
    }

    // No destructor teardown: the pool lives for the process. (Static
    // destruction order vs. in-flight work makes joining at exit more
    // dangerous than letting the OS reap the threads.)

    void run(Job &j) {
        {
            std::lock_guard<std::mutex> lk(mu_);
            jobs_.push_back(&j);
        }
        // wake enough workers for the job (notify_all: waking an idle
        // worker that finds nothing to do is cheap; missing one stalls)
        cv_.notify_all();
        // caller participates: claim items from its own job only
        for (;;) {
            int i = j.next.fetch_add(1, std::memory_order_relaxed);
            if (i >= j.n) break;
            (*j.fn)(i);
            finish_one(j);
        }
        // remove from the deque so no worker can find it after return
        {
            std::lock_guard<std::mutex> lk(mu_);
            for (auto it = jobs_.begin(); it != jobs_.end(); ++it)
                if (*it == &j) {
                    jobs_.erase(it);
                    break;
                }
        }
        std::unique_lock<std::mutex> lk(j.m);
        j.cv.wait(lk, [&]() { return j.done >= j.n; });
    }

  private:
    static void finish_one(Job &j) {
        std::lock_guard<std::mutex> lk(j.m);
        if (++j.done == j.n) j.cv.notify_one();
    }

    void worker() {
        in_worker = true;
        std::unique_lock<std::mutex> lk(mu_);
        for (;;) {
            while (jobs_.empty()) cv_.wait(lk);
            Job *j = jobs_.front();
            int i = j->next.fetch_add(1, std::memory_order_relaxed);
            if (i >= j->n) {
                // exhausted: drop it if it is still queued, try others
                for (auto it = jobs_.begin(); it != jobs_.end(); ++it)
                    if (*it == j) {
                        jobs_.erase(it);
                        break;
                    }
                continue;
            }
            lk.unlock();
            (*j->fn)(i);
            finish_one(*j);
            lk.lock();
        }
    }

    std::mutex mu_;
    std::condition_variable cv_;
    std::deque<Job *> jobs_;
    std::vector<std::thread> workers_;
};

std::atomic<Pool *> g_pool{nullptr};
std::mutex g_pool_mu;

int affinity_count() {
#ifdef __linux__
    cpu_set_t cs;
    if (sched_getaffinity(0, sizeof(cs), &cs) == 0) {
        int n = CPU_COUNT(&cs);
        if (n > 0) return n;
    }
#endif
    unsigned hc = std::thread::hardware_concurrency();
    return hc > 0 ? (int)hc : 1;
}

Pool *get_pool() {
    Pool *p = g_pool.load(std::memory_order_acquire);
    if (p) return p;
    std::lock_guard<std::mutex> lk(g_pool_mu);
    p = g_pool.load(std::memory_order_relaxed);
    if (p) return p;
    int n = affinity_count();
    if (n > 16) n = 16;
    p = new Pool(n);  // workers == cores: callers sleep while waiting
    g_pool.store(p, std::memory_order_release);
    return p;
}

void atfork_child() {
    // parent's worker threads do not exist here; abandon the pool
    // object (leak: fork happens O(1) times) and re-create lazily
    g_pool.store(nullptr, std::memory_order_release);
    new (&g_pool_mu) std::mutex();
}

__attribute__((constructor)) void init_native_runtime() {
    pthread_atfork(nullptr, nullptr, atfork_child);
#ifdef M_MMAP_THRESHOLD
    // Large short-lived buffers (pileup tensors, row scratch, inflate
    // batches) otherwise round-trip through mmap/munmap per block —
    // the munmap TLB shootdowns were measured at ~2s sys per run on a
    // 4-core VM. Keep them on the heap and don't trim eagerly.
    mallopt(M_MMAP_THRESHOLD, 512 << 20);
    mallopt(M_TRIM_THRESHOLD, 256 << 20);
#endif
}

}  // namespace

int pool_size() { return get_pool() ? affinity_count() : 1; }

// --- opt-in phase profiling (BSC_PROF=1): cumulative seconds per
// labeled phase, printed to stderr at exit. Builder tooling for the
// PERF.md wall-time split; zero cost when the env var is unset. ---

namespace {
struct ProfEntry {
    const char *name;
    std::atomic<int64_t> ns{0};
    std::atomic<int64_t> calls{0};
};
constexpr int kMaxProf = 64;
ProfEntry g_prof[kMaxProf];
std::atomic<int> g_prof_n{0};
bool prof_enabled() {
    static const bool on = [] {
        const char *v = getenv("BSC_PROF");
        return v && *v && *v != '0';
    }();
    return on;
}
void prof_report() {
    int n = g_prof_n.load();
    for (int i = 0; i < n; i++)
        fprintf(stderr, "BSC_PROF %-24s %8.3fs  x%lld\n", g_prof[i].name,
                g_prof[i].ns.load() / 1e9,
                (long long)g_prof[i].calls.load());
}
}  // namespace

bool prof_on() { return prof_enabled(); }

void prof_add(int *slot, const char *name, int64_t ns) {
    int s = *slot;
    if (s < 0) {
        static std::mutex m;
        std::lock_guard<std::mutex> lk(m);
        s = *slot;
        if (s < 0) {
            s = g_prof_n.load();
            if (s >= kMaxProf) return;
            g_prof[s].name = name;
            if (s == 0) atexit(prof_report);
            g_prof_n.store(s + 1);
            *slot = s;
        }
    }
    g_prof[s].ns.fetch_add(ns, std::memory_order_relaxed);
    g_prof[s].calls.fetch_add(1, std::memory_order_relaxed);
}

void pool_run(int n, const std::function<void(int)> &fn) {
    if (n <= 0) return;
    if (n == 1 || in_worker) {
        for (int i = 0; i < n; i++) fn(i);
        return;
    }
    Job j;
    j.fn = &fn;
    j.n = n;
    get_pool()->run(j);
}

}  // namespace bsc
