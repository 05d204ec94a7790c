// The table gathers of the COPIFT log's vector kernel, side by side, so that
// tools/logf_variants.py can time them on the same card in one run.  The
// kernel, its phases, its policies and its checks are
// src/repro_torch/csrc/logf.cu's own (included whole); only the Tables
// policy differs:
// - shared: the tables copied into shared memory behind a __syncthreads,
//   once per 8 KB chunk (SharedTables);
// - shuffle: lane l of each warp holds entry l & 15 of both tables in
//   registers and the gather is __shfl_sync (ShuffleTables, the one
//   copift_log_vec_f32 ships);
// - ldg: __ldg from the device tables (LdgTables).
// Each launcher takes what copift_log_vec_f32 takes.
#include "logf.cu"

#define LOGF_VARIANT(name, Tables)                                          \
  extern "C" int name(const float* x, float* y, int64_t n4, int64_t n,      \
                      int threads, const float* invc, const float* logc,    \
                      cudaStream_t stream) {                                \
    return launch_vec<Tables>(x, y, n4, n, threads, invc, logc, stream);    \
  }

LOGF_VARIANT(logf_variant_shared, SharedTables)
LOGF_VARIANT(logf_variant_shuffle, ShuffleTables)
LOGF_VARIANT(logf_variant_ldg, LdgTables)
