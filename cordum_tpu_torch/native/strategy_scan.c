/* Native worker-selection scan: the scheduler's hottest loop.
 *
 * The least-loaded strategy scans every live worker per dispatch
 * (reference strategy_least_loaded.go:40-140; its published number is
 * 18,234 selections/s at 1000 workers).  The Python scan is O(workers) of
 * interpreted attribute access; this C kernel runs the same selection over
 * packed parallel arrays the registry maintains incrementally.
 *
 * Selection semantics (must match cordum_tpu_torch/controlplane/scheduler/
 * strategy.py — tested against it):
 *   eligible = pool_mask & capability_mask & chips & topology & healthy
 *              & !overloaded(active>=0.9*max || cpu>=90 || duty>=90)
 *   score    = active_jobs + cpu/100 + duty/100 ; least wins,
 *              ties broken by lowest worker index (caller sorts ids).
 *
 * Capability/pool/topology matching is precomputed by the caller into
 * bitmasks: each job presents a required-capability bitmask (bit i set ->
 * worker must have capability i) plus pool-membership and topology-id
 * columns.  Returns the winning worker index or -1.
 *
 * Build: cc -O2 -shared -fPIC -o libstrategy_scan.so strategy_scan.c
 */
#include <stdint.h>

#define OVERLOAD_FRACTION 0.9
#define OVERLOAD_UTIL 90.0

/* returns index of best worker, or -1 if none eligible */
int32_t pick_worker(
    int32_t n,
    const uint64_t *cap_bits,      /* per-worker capability bitmask        */
    const int32_t *pool_id,        /* per-worker pool id                   */
    const int32_t *topology_id,    /* per-worker topology id (0 = none)    */
    const int32_t *chip_count,     /* per-worker chips                     */
    const float *active_jobs,      /* per-worker active jobs               */
    const float *max_parallel,     /* per-worker max parallel (0 = unset)  */
    const float *cpu_load,         /* per-worker cpu %                     */
    const float *duty_cycle,       /* per-worker TPU duty %                */
    const uint8_t *healthy,        /* per-worker device health             */
    uint64_t req_caps,             /* required capability bits             */
    const int32_t *allowed_pools,  /* eligible pool ids for the topic      */
    int32_t n_pools,
    int32_t min_chips,
    int32_t req_topology_id        /* 0 = any */
) {
    int32_t best = -1;
    double best_score = 1e30;
    for (int32_t i = 0; i < n; i++) {
        if (!healthy[i]) continue;
        if ((cap_bits[i] & req_caps) != req_caps) continue;
        if (min_chips > 0 && chip_count[i] < min_chips) continue;
        if (req_topology_id != 0 && topology_id[i] != req_topology_id) continue;
        if (n_pools > 0) {
            int ok = 0;
            for (int32_t p = 0; p < n_pools; p++) {
                if (pool_id[i] == allowed_pools[p]) { ok = 1; break; }
            }
            if (!ok) continue;
        }
        if (max_parallel[i] > 0.0f &&
            active_jobs[i] >= OVERLOAD_FRACTION * max_parallel[i]) continue;
        if (cpu_load[i] >= OVERLOAD_UTIL || duty_cycle[i] >= OVERLOAD_UTIL) continue;
        double score = (double)active_jobs[i]
                     + (double)cpu_load[i] / 100.0
                     + (double)duty_cycle[i] / 100.0;
        if (score < best_score) {
            best_score = score;
            best = i;
        }
    }
    return best;
}
