// Pooled attention with a decomposed relative-position bias on Hopper:
// forward, and the backward in two kernels (dq + dbias, then dk + dv).
//
// Replaces the TPU kernels of audiossl_tpu/ops/attention.py:146
// fused_rel_attention: the forward _fwd_kernel (:88) and the backward
// _bwd_kernel (:95), per (batch * head):
//
//   s   = qs k^T + bias E          qs = q * scale, rounded to the stream dtype
//   p   = softmax(s)               f32, exact over the whole key row
//   out = round(p) v               f32 accumulation, out in v's dtype
//
// E is the 0/1 expansion of rel_expand_matrix(kh, kw), the only E the MViT
// call site passes (models/mvit.py:320), so the kernels read the bias
// decomposed: s[q, j] += bias[q, j / kw] + bias[q, kh + j % kw]. With kh = kw
// = 0 there is no bias (the no-bias mode, plain ViT/AST attention).
//
// Backward, as _bwd_kernel (:105-119) computes it, recomputing p (the score
// matrix is never stored, as on the TPU):
//   dp = dO v^T,   ds = p (dp - rowsum(dp p)),   dq = round(round(ds) k) * scale,
//   dbias = ds E^T (f32),   dk = round(ds)^T qs,   dv = round(p)^T dO.
// attn_bwd_dq_kernel takes one block per (b*h, q-tile) and writes dq, dbias
// and each row's softmax max, sum and rowsum(dp p); attn_bwd_dkv_kernel takes
// one block per (b*h, key tile), loops over every q-tile in order and rebuilds
// p and ds from those row statistics with the same arithmetic, so the two
// kernels see the same p bit for bit. On the TPU dk and dv accumulate across
// q-tiles in an output block revisited in grid order; here the loop inside
// the block takes that place: no float atomics, and two runs give the same
// bits.
//
// Precision: every product is f32 FFMA on f32 values (bf16 operands are
// widened exactly), the counterpart of the JAX package's HIGHEST parity path
// in f32; no TF32, no tensor cores. Rounding to the stream dtype happens where
// the JAX kernel rounds: p before p v, ds and p before the dk/dv/dq products,
// dq before its scale.
//
// Design: one block of 256 threads (8 warps). The forward stages k
// transposed ([D][Lk | 1], odd stride: conflict-free both along keys and
// along D), its q-tile transposed and the tile's bias rows in shared memory;
// a thread computes the scores of one key for 8 query rows (float4 loads of
// the q tile), a warp takes the softmax of a row, the buffer of k is reused
// for v, and a warp computes 4 (or fewer) output rows, lanes over D. The
// q-tile is 32, 16 or 8 rows, whichever fits beside k (or v) and the score
// tile in the 227 KB of shared memory; keys longer than that raise in the
// wrapper. D <= 128.
//
// Bound on an H100 SXM: at MAST-B's shapes (B = 64, two views in one pass,
// D = 96) the forward moves, e.g. at (BH, Lq, Lk) = (128, 1212, 78), 72.4 MB
// of q, k, v, bias and out in bf16 (21.6 us at 3.35 TB/s) for 4.6 GFLOP of
// products (4.7 us at 989 TFLOP/s bf16): bound by bytes (chip_smoke.py's
// attention_bound computes it for every shape). This design runs on the f32
// pipe (67 TFLOP/s, 69 us for those products) and rereads k and v from L2
// for every q-tile; mma.sync or wgmma tiles are the way closer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kTK = 32;   // keys per block of the dk/dv kernel (one per lane)
constexpr int kTQ2 = 32;  // query rows per step of the dk/dv kernel's loop
constexpr int kSmemLimit = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__host__ __device__ inline int align16(long long bytes) { return static_cast<int>((bytes + 15) & ~15LL); }
__host__ __device__ inline int odd(int n) { return n | 1; }

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// out[r][j] = sum_c at[c][r] * bt[c][j] (+ bias[r][(j0 + j) / kw] + bias[r][kh + (j0 + j) % kw]),
// for r < TQ and j < nj; at is [d][TQ] f32, bt [d][ldb]. Every kernel computes
// a score with this one sequence of FMAs, so the scores agree bit for bit.
template <int RPI, int TQ, typename TB>
__device__ void score_tile(const float* at, const TB* bt, int ldb, int nj, int j0, int d,
                           const float* bs, int kb, int kh, int kw, float* out, int ldo) {
    constexpr int groups = TQ / RPI;
    for (int item = threadIdx.x; item < nj * groups; item += kThreads) {
        const int j = item % nj;
        const int r0 = (item / nj) * RPI;
        float acc[RPI];
#pragma unroll
        for (int r = 0; r < RPI; ++r) acc[r] = 0.0f;
        for (int c = 0; c < d; ++c) {
            const float b = to_f(bt[c * ldb + j]);
            const float4* ap = reinterpret_cast<const float4*>(at + c * TQ + r0);
#pragma unroll
            for (int p = 0; p < RPI / 4; ++p) {
                const float4 a = ap[p];
                acc[4 * p] = fmaf(a.x, b, acc[4 * p]);
                acc[4 * p + 1] = fmaf(a.y, b, acc[4 * p + 1]);
                acc[4 * p + 2] = fmaf(a.z, b, acc[4 * p + 2]);
                acc[4 * p + 3] = fmaf(a.w, b, acc[4 * p + 3]);
            }
        }
        const int jg = j0 + j;
#pragma unroll
        for (int r = 0; r < RPI; ++r) {
            float v = acc[r];
            if (bs != nullptr) v += bs[(r0 + r) * kb + jg / kw] + bs[(r0 + r) * kb + kh + jg % kw];
            out[(r0 + r) * ldo + j] = v;
        }
    }
}

// Softmax of each of the TQ rows of s [TQ][ld] over its first n entries, in
// place, a warp per row; with ROUND the probabilities are rounded to T. The
// row's max and sum go to stats[r] and stats[TQ + r] when stats is given.
template <typename T, int TQ, bool ROUND>
__device__ void softmax_rows(float* s, int ld, int n, float* stats) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < TQ; r += kWarps) {
        float* row = s + r * ld;
        float m = __int_as_float(0xff800000);  // -inf
        for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
        m = warp_max(m);
        float l = 0.0f;
        for (int j = lane; j < n; j += 32) l += expf(row[j] - m);
        l = warp_sum(l);
        for (int j = lane; j < n; j += 32) {
            const float p = expf(row[j] - m) / l;
            row[j] = ROUND ? round_to<T>(p) : p;
        }
        if (stats != nullptr && lane == 0) {
            stats[r] = m;
            stats[TQ + r] = l;
        }
    }
}

// acc[i][u] = sum_j p[r][j] * b[j][c] for the rows r = warp + 8 i and the
// columns c = lane + 32 u; b is [nj][d] natural; with ROUND p is rounded to T
// first.
template <typename T, int TQ, bool ROUND, typename TB>
__device__ void rows_times(const float* p, int ldp, const TB* b, int nj, int d, float (&acc)[TQ / kWarps][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < TQ / kWarps; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
    for (int j = 0; j < nj; ++j) {
        float bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = lane + 32 * u;
            bv[u] = c < d ? to_f(b[j * d + c]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < TQ / kWarps; ++i) {
            float pv = p[(warp + kWarps * i) * ldp + j];
            if (ROUND) pv = round_to<T>(pv);
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(pv, bv[u], acc[i][u]);
        }
    }
}

// dst[c * ld + j] = src[j * d + c] for j < n (a [n][d] matrix transposed).
template <typename T, typename TD>
__device__ void load_transposed(const T* __restrict__ src, int n, int d, TD* dst, int ld) {
    for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
        const int j = idx / d, c = idx - j * d;
        dst[c * ld + j] = from_f<TD>(to_f(src[idx]));  // exact: f32 holds every bf16
    }
}

// The rows q0 .. q0 + TQ - 1 of a [lq][w] matrix into dst, as f32: transposed
// [w][TQ] or natural [TQ][w]; rows past lq are zeros.
template <typename T, int TQ, bool TRANSPOSE>
__device__ void load_rows(const T* __restrict__ src, int lq, int q0, int w, float* dst) {
    for (int idx = threadIdx.x; idx < TQ * w; idx += kThreads) {
        const int r = idx / w, c = idx - r * w;
        const int row = q0 + r;
        const float v = row < lq ? to_f(src[static_cast<long long>(row) * w + c]) : 0.0f;
        dst[TRANSPOSE ? c * TQ + r : idx] = v;
    }
}

template <typename T, int TQ>
__host__ __device__ inline int fwd_smem(int lk, int d, int kb) {
    return align16(static_cast<long long>(sizeof(T)) * d * odd(lk)) + 4 * d * TQ + 4 * TQ * odd(lk) + align16(4LL * TQ * kb);
}

template <typename T, int TQ>
__host__ __device__ inline int dq_smem(int lk, int d, int kb) {
    return align16(static_cast<long long>(sizeof(T)) * d * odd(lk)) + 4 * d * TQ + 8 * TQ * odd(lk) + align16(4LL * TQ * kb) +
           8 * TQ;
}

template <typename T>
__host__ __device__ inline int dkv_smem(int d, int kb) {
    return 4 * (2 * d * kTK + 2 * d * kTQ2 + 2 * kTQ2 * kTK) + align16(4LL * kTQ2 * kb) + 12 * kTQ2;
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ bias, int lq, int lk, int d, int kh, int kw, int tiles, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kb = kh + kw;
    const int ldk = odd(lk);
    T* kv = reinterpret_cast<T*>(smem);
    float* qt = reinterpret_cast<float*>(smem + align16(static_cast<long long>(sizeof(T)) * d * ldk));
    float* s = qt + d * TQ;
    float* bs = s + TQ * ldk;
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * TQ;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;

    load_transposed(k + kbase, lk, d, kv, ldk);
    load_rows<T, TQ, true>(qs + qbase, lq, q0, d, qt);
    if (bias != nullptr) load_rows<T, TQ, false>(bias + static_cast<long long>(bh) * lq * kb, lq, q0, kb, bs);
    __syncthreads();
    score_tile<8, TQ>(qt, kv, ldk, lk, 0, d, bias != nullptr ? bs : nullptr, kb, kh, kw, s, ldk);
    __syncthreads();
    softmax_rows<T, TQ, true>(s, ldk, lk, nullptr);
    __syncthreads();
    for (int idx = threadIdx.x; idx < lk * d; idx += kThreads) kv[idx] = v[kbase + idx];
    __syncthreads();
    float acc[TQ / kWarps][4];
    rows_times<T, TQ, false>(s, ldk, kv, lk, d, acc);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < TQ / kWarps; ++i) {
        const int row = q0 + warp + kWarps * i;
        if (row >= lq) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = lane + 32 * u;
            if (c < d) out[qbase + static_cast<long long>(row) * d + c] = from_f<T>(acc[i][u]);
        }
    }
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ bias, const T* __restrict__ dout, int lq, int lk, int d, int kh, int kw,
                   int tiles, float scale, T* __restrict__ dq, T* __restrict__ dbias, float* __restrict__ stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int kb = kh + kw;
    const int ldk = odd(lk);
    T* kv = reinterpret_cast<T*>(smem);
    float* qt = reinterpret_cast<float*>(smem + align16(static_cast<long long>(sizeof(T)) * d * ldk));
    float* s = qt + d * TQ;
    float* g = s + TQ * ldk;
    float* bs = g + TQ * ldk;
    float* st = bs + align16(4LL * TQ * kb) / 4;  // [2][TQ]: row max, row sum
    const int bh = blockIdx.x / tiles;
    const int q0 = (blockIdx.x % tiles) * TQ;
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    load_transposed(k + kbase, lk, d, kv, ldk);
    load_rows<T, TQ, true>(qs + qbase, lq, q0, d, qt);
    if (bias != nullptr) load_rows<T, TQ, false>(bias + static_cast<long long>(bh) * lq * kb, lq, q0, kb, bs);
    __syncthreads();
    score_tile<8, TQ>(qt, kv, ldk, lk, 0, d, bias != nullptr ? bs : nullptr, kb, kh, kw, s, ldk);
    __syncthreads();
    softmax_rows<T, TQ, false>(s, ldk, lk, st);  // p, f32
    __syncthreads();
    load_transposed(v + kbase, lk, d, kv, ldk);
    load_rows<T, TQ, true>(dout + qbase, lq, q0, d, qt);
    __syncthreads();
    score_tile<8, TQ>(qt, kv, ldk, lk, 0, d, static_cast<const float*>(nullptr), 0, 0, 1, g, ldk);  // dp
    __syncthreads();
    for (int r = warp; r < TQ; r += kWarps) {  // ds = p (dp - rowsum(dp p)), in place of dp
        const float* p = s + r * ldk;
        float* row = g + r * ldk;
        float delta = 0.0f;
        for (int j = lane; j < lk; j += 32) delta = fmaf(row[j], p[j], delta);
        delta = warp_sum(delta);
        for (int j = lane; j < lk; j += 32) row[j] = p[j] * (row[j] - delta);
        const int q = q0 + r;
        if (lane == 0 && q < lq) {
            float* out = stats + (static_cast<long long>(bh) * lq + q) * 3;
            out[0] = st[r];
            out[1] = st[TQ + r];
            out[2] = delta;
        }
    }
    __syncthreads();
    if (bias != nullptr) {  // dbias = ds E^T: sums of ds over key-grid rows, then over columns
        for (int idx = threadIdx.x; idx < TQ * kb; idx += kThreads) {
            const int r = idx / kb, e = idx - r * kb;
            const int q = q0 + r;
            if (q >= lq) continue;
            const float* row = g + r * ldk;
            float sum = 0.0f;
            if (e < kh) {
                for (int c = 0; c < kw; ++c) sum += row[e * kw + c];
            } else {
                for (int rr = 0; rr < kh; ++rr) sum += row[rr * kw + (e - kh)];
            }
            dbias[(static_cast<long long>(bh) * lq + q) * kb + e] = from_f<T>(sum);
        }
    }
    for (int idx = threadIdx.x; idx < lk * d; idx += kThreads) kv[idx] = k[kbase + idx];
    __syncthreads();
    float acc[TQ / kWarps][4];
    rows_times<T, TQ, true>(g, ldk, kv, lk, d, acc);
#pragma unroll
    for (int i = 0; i < TQ / kWarps; ++i) {
        const int row = q0 + warp + kWarps * i;
        if (row >= lq) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int c = lane + 32 * u;
            if (c < d) dq[qbase + static_cast<long long>(row) * d + c] = from_f<T>(round_to<T>(acc[i][u]) * scale);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ qs, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ bias, const T* __restrict__ dout, const float* __restrict__ stats,
                    int lq, int lk, int d, int kh, int kw, int ktiles, T* __restrict__ dk, T* __restrict__ dv) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int TQ = kTQ2;
    const int kb = kh + kw;
    float* kt = reinterpret_cast<float*>(smem);  // [d][kTK]
    float* vt = kt + d * kTK;                     // [d][kTK]
    float* qt = vt + d * kTK;                     // [d][TQ]
    float* dt = qt + d * TQ;                      // [d][TQ]
    float* p = dt + d * TQ;                       // [TQ][kTK]
    float* g = p + TQ * kTK;                      // [TQ][kTK]
    float* bs = g + TQ * kTK;                     // [TQ][kb]
    float* st = bs + align16(4LL * TQ * kb) / 4;  // [TQ][3]: max, sum, rowsum(dp p)
    const int bh = blockIdx.x / ktiles;
    const int j0 = (blockIdx.x % ktiles) * kTK;
    const int nj = min(kTK, lk - j0);
    const long long kbase = static_cast<long long>(bh) * lk * d;
    const long long qbase = static_cast<long long>(bh) * lq * d;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    for (int idx = threadIdx.x; idx < kTK * d; idx += kThreads) {
        const int j = idx / d, c = idx - j * d;
        const bool in = j < nj;
        kt[c * kTK + j] = in ? to_f(k[kbase + static_cast<long long>(j0 + j) * d + c]) : 0.0f;
        vt[c * kTK + j] = in ? to_f(v[kbase + static_cast<long long>(j0 + j) * d + c]) : 0.0f;
    }
    float dk_acc[kMaxD / kWarps], dv_acc[kMaxD / kWarps];  // columns c = warp + 8 u, key j0 + lane
#pragma unroll
    for (int u = 0; u < kMaxD / kWarps; ++u) dk_acc[u] = dv_acc[u] = 0.0f;

    for (int q0 = 0; q0 < lq; q0 += TQ) {
        __syncthreads();
        load_rows<T, TQ, true>(qs + qbase, lq, q0, d, qt);
        load_rows<T, TQ, true>(dout + qbase, lq, q0, d, dt);
        if (bias != nullptr) load_rows<T, TQ, false>(bias + static_cast<long long>(bh) * lq * kb, lq, q0, kb, bs);
        for (int idx = threadIdx.x; idx < 3 * TQ; idx += kThreads) {
            const int q = q0 + idx / 3;
            st[idx] = q < lq ? stats[(static_cast<long long>(bh) * lq + q0) * 3 + idx] : 0.0f;
        }
        __syncthreads();
        score_tile<4, TQ>(qt, kt, kTK, nj, j0, d, bias != nullptr ? bs : nullptr, kb, kh, kw, p, kTK);
        score_tile<4, TQ>(dt, vt, kTK, nj, j0, d, static_cast<const float*>(nullptr), 0, 0, 1, g, kTK);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TQ * kTK; idx += kThreads) {
            const int r = idx / kTK, j = idx - r * kTK;
            if (q0 + r < lq && j < nj) {
                const float pr = expf(p[idx] - st[3 * r]) / st[3 * r + 1];
                const float ds = pr * (g[idx] - st[3 * r + 2]);
                p[idx] = round_to<T>(pr);
                g[idx] = round_to<T>(ds);
            } else {
                p[idx] = g[idx] = 0.0f;
            }
        }
        __syncthreads();
        for (int r = 0; r < TQ; ++r) {
            const float pj = p[r * kTK + lane];
            const float gj = g[r * kTK + lane];
#pragma unroll
            for (int u = 0; u < kMaxD / kWarps; ++u) {
                const int c = warp + kWarps * u;
                if (c < d) {
                    dk_acc[u] = fmaf(gj, qt[c * TQ + r], dk_acc[u]);
                    dv_acc[u] = fmaf(pj, dt[c * TQ + r], dv_acc[u]);
                }
            }
        }
    }
    if (lane < nj) {
        const long long base = kbase + static_cast<long long>(j0 + lane) * d;
#pragma unroll
        for (int u = 0; u < kMaxD / kWarps; ++u) {
            const int c = warp + kWarps * u;
            if (c < d) {
                dk[base + c] = from_f<T>(dk_acc[u]);
                dv[base + c] = from_f<T>(dv_acc[u]);
            }
        }
    }
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

template <typename T>
int tile_rows(int which, int lk, int d, int kb) {
    if (which == 0) {
        if (fwd_smem<T, 32>(lk, d, kb) <= kSmemLimit) return 32;
        if (fwd_smem<T, 16>(lk, d, kb) <= kSmemLimit) return 16;
        if (fwd_smem<T, 8>(lk, d, kb) <= kSmemLimit) return 8;
        return 0;
    }
    if (which == 1) {
        if (dq_smem<T, 32>(lk, d, kb) <= kSmemLimit) return 32;
        if (dq_smem<T, 16>(lk, d, kb) <= kSmemLimit) return 16;
        if (dq_smem<T, 8>(lk, d, kb) <= kSmemLimit) return 8;
        return 0;
    }
    return dkv_smem<T>(d, kb) <= kSmemLimit ? kTQ2 : 0;
}

template <typename T, int TQ>
int fwd_launch(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq, int lk, int d,
               int kh, int kw, void* out, cudaStream_t stream) {
    const int smem = fwd_smem<T, TQ>(lk, d, kh + kw);
    const int err = prepare(attn_fwd_kernel<T, TQ>, smem);
    if (err) return err;
    const int tiles = (lq + TQ - 1) / TQ;
    attn_fwd_kernel<T, TQ><<<bh * tiles, kThreads, smem, stream>>>(
        static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(bias),
        lq, lk, d, kh, kw, tiles, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int TQ>
int dq_launch(const void* qs, const void* k, const void* v, const void* bias, const void* dout, int bh, int lq,
              int lk, int d, int kh, int kw, float scale, void* dq, void* dbias, float* stats, cudaStream_t stream) {
    const int smem = dq_smem<T, TQ>(lk, d, kh + kw);
    const int err = prepare(attn_bwd_dq_kernel<T, TQ>, smem);
    if (err) return err;
    const int tiles = (lq + TQ - 1) / TQ;
    attn_bwd_dq_kernel<T, TQ><<<bh * tiles, kThreads, smem, stream>>>(
        static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(bias),
        static_cast<const T*>(dout), lq, lk, d, kh, kw, tiles, scale, static_cast<T*>(dq), static_cast<T*>(dbias),
        stats);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dkv_launch(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
               const float* stats, int bh, int lq, int lk, int d, int kh, int kw, void* dk, void* dv,
               cudaStream_t stream) {
    const int smem = dkv_smem<T>(d, kh + kw);
    const int err = prepare(attn_bwd_dkv_kernel<T>, smem);
    if (err) return err;
    const int ktiles = (lk + kTK - 1) / kTK;
    attn_bwd_dkv_kernel<T><<<bh * ktiles, kThreads, smem, stream>>>(
        static_cast<const T*>(qs), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(bias),
        static_cast<const T*>(dout), stats, lq, lk, d, kh, kw, ktiles, static_cast<T*>(dk), static_cast<T*>(dv));
    return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int bh, int lq, int lk, int d, int kh, int kw) {
    return bh <= 0 || lq <= 0 || lk <= 0 || d <= 0 || d > kMaxD || kh < 0 || kw < 0 || (kh + kw > 0 && kh * kw != lk);
}

}  // namespace

// Query rows per block that kernel `which` (0 forward, 1 dq/dbias, 2 dk/dv)
// takes for these keys, head width and bias width, in bf16 (1) or f32 (0);
// 0 when the keys do not fit in shared memory.
extern "C" int audiossl_attn_tile(int which, int lk, int d, int kb, int bf16) {
    return bf16 ? tile_rows<__nv_bfloat16>(which, lk, d, kb) : tile_rows<float>(which, lk, d, kb);
}

// q scaled (qs), k, v [bh, lq | lk, d] and bias [bh, lq, kh + kw] (null with
// kh = kw = 0) in one dtype, contiguous; out [bh, lq, d]. Each entry point
// returns cudaGetLastError() after its launch (0 on success), launches on
// `stream`, allocates nothing and does not synchronise.
extern "C" int audiossl_attn_fwd(const void* qs, const void* k, const void* v, const void* bias, int bh, int lq,
                                 int lk, int d, int kh, int kw, int bf16, void* out, void* stream) {
    if (bad_shape(bh, lq, lk, d, kh, kw) || (bias == nullptr) != (kh + kw == 0)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (audiossl_attn_tile(0, lk, d, kh + kw, bf16) * 2 + (bf16 ? 1 : 0)) {
        case 64: return fwd_launch<float, 32>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
        case 32: return fwd_launch<float, 16>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
        case 16: return fwd_launch<float, 8>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
        case 65: return fwd_launch<__nv_bfloat16, 32>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
        case 33: return fwd_launch<__nv_bfloat16, 16>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
        case 17: return fwd_launch<__nv_bfloat16, 8>(qs, k, v, bias, bh, lq, lk, d, kh, kw, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// dout [bh, lq, d]; writes dq [bh, lq, d] (times `scale`), dbias [bh, lq, kh + kw]
// (when there is a bias) and stats [bh, lq, 3] f32 for audiossl_attn_bwd_dkv.
extern "C" int audiossl_attn_bwd_dq(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
                                    int bh, int lq, int lk, int d, int kh, int kw, int bf16, float scale, void* dq,
                                    void* dbias, float* stats, void* stream) {
    if (bad_shape(bh, lq, lk, d, kh, kw) || (bias == nullptr) != (kh + kw == 0)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (audiossl_attn_tile(1, lk, d, kh + kw, bf16) * 2 + (bf16 ? 1 : 0)) {
        case 64: return dq_launch<float, 32>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
        case 32: return dq_launch<float, 16>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
        case 16: return dq_launch<float, 8>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
        case 65: return dq_launch<__nv_bfloat16, 32>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
        case 33: return dq_launch<__nv_bfloat16, 16>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
        case 17: return dq_launch<__nv_bfloat16, 8>(qs, k, v, bias, dout, bh, lq, lk, d, kh, kw, scale, dq, dbias, stats, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// From the stats audiossl_attn_bwd_dq wrote: dk, dv [bh, lk, d].
extern "C" int audiossl_attn_bwd_dkv(const void* qs, const void* k, const void* v, const void* bias, const void* dout,
                                     const float* stats, int bh, int lq, int lk, int d, int kh, int kw, int bf16,
                                     void* dk, void* dv, void* stream) {
    if (bad_shape(bh, lq, lk, d, kh, kw) || (bias == nullptr) != (kh + kw == 0)) return static_cast<int>(cudaErrorInvalidValue);
    if (audiossl_attn_tile(2, lk, d, kh + kw, bf16) == 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return bf16 ? dkv_launch<__nv_bfloat16>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, s)
                : dkv_launch<float>(qs, k, v, bias, dout, stats, bh, lq, lk, d, kh, kw, dk, dv, s);
}
