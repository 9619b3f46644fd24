/* Native host-side batcher: random-window gather over a uint16 token stream
 * (the port's copy of midgpt_tpu/native/batcher.c, the same code).
 *
 * The training loop's host-side work is assembling (x, y=x+1) int32
 * windows from the token stream (midgpt_tpu_torch/data/dataset.py
 * sample_batch). numpy does this as two fancy-indexing gathers, each
 * materializing a (B*G, T) index matrix and walking the stream twice with
 * per-element index arithmetic. This C kernel does one contiguous pass per
 * window -- read T+1 tokens once, widen to int32, write x and y together --
 * parallelized across windows with pthreads. Its times on the card's host
 * are chip_smoke.py phase 22c's (PERF.md).
 *
 * Contract (ctypes, see midgpt_tpu_torch/native/__init__.py):
 *   sample_windows(data, n_windows, T, starts, x_out, y_out, n_threads)
 *     data:    const uint16_t*  token stream (memmap or RAM)
 *     starts:  const int64_t*   window start offsets, n_windows of them
 *     x_out:   int32_t*         (n_windows, T) row-major
 *     y_out:   int32_t*         (n_windows, T) row-major
 *
 * Bounds are the caller's responsibility (starts[i] + T < len(data)), as
 * with the numpy path it replaces. Python owns the RNG: the same seeded
 * numpy Generator produces `starts`, so native and numpy paths are
 * bit-identical (tests/test_torch_native_batcher.py).
 */

#include <pthread.h>
#include <stdint.h>
#include <stddef.h>

typedef struct {
    const uint16_t *data;
    const int64_t *starts;
    int32_t *x_out;
    int32_t *y_out;
    int64_t t;        /* window length */
    int64_t begin;    /* first window index (inclusive) */
    int64_t end;      /* last window index (exclusive) */
} job_t;

static void *worker(void *arg)
{
    job_t *j = (job_t *)arg;
    const int64_t t = j->t;
    for (int64_t w = j->begin; w < j->end; ++w) {
        const uint16_t *src = j->data + j->starts[w];
        int32_t *x = j->x_out + w * t;
        int32_t *y = j->y_out + w * t;
        /* one pass: src[0..t] read once, x gets src[i], y gets src[i+1] */
        int32_t prev = (int32_t)src[0];
        for (int64_t i = 0; i < t; ++i) {
            int32_t next = (int32_t)src[i + 1];
            x[i] = prev;
            y[i] = next;
            prev = next;
        }
    }
    return NULL;
}

void sample_windows(const uint16_t *data, int64_t n_windows, int64_t t,
                    const int64_t *starts, int32_t *x_out, int32_t *y_out,
                    int64_t n_threads)
{
    if (n_threads < 1)
        n_threads = 1;
    if (n_threads > n_windows)
        n_threads = n_windows > 0 ? n_windows : 1;

    enum { MAX_THREADS = 64 };
    if (n_threads > MAX_THREADS)
        n_threads = MAX_THREADS;

    pthread_t tids[MAX_THREADS];
    job_t jobs[MAX_THREADS];
    int64_t per = (n_windows + n_threads - 1) / n_threads;

    int64_t spawned = 0;
    for (int64_t i = 0; i < n_threads; ++i) {
        int64_t begin = i * per;
        int64_t end = begin + per > n_windows ? n_windows : begin + per;
        if (begin >= end)
            break;
        jobs[i] = (job_t){data, starts, x_out, y_out, t, begin, end};
        if (i == n_threads - 1 || begin + per >= n_windows) {
            /* run the last slice inline — saves one thread spawn */
            worker(&jobs[i]);
            spawned = i;
            break;
        }
        pthread_create(&tids[i], NULL, worker, &jobs[i]);
        spawned = i + 1;
    }
    for (int64_t i = 0; i < spawned; ++i)
        pthread_join(tids[i], NULL);
}
