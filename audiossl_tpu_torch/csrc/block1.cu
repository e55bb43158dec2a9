// AudioNTT block 1 on Hopper: Conv3x3 (C_in = 1) -> BatchNorm -> ReLU -> MaxPool 2x2,
// forward and its two backward passes, on the reference layout x [B, 1, F, T].
//
// Replaces the TPU kernels of audiossl_tpu/ops/block1.py:
//   block1_fwd        <- _apply_kernel (:174), the fused_block1 forward
//   block1_bwd_sums   <- _bwd1_kernel  (:216), per-channel sum(dy), sum(dy * y_raw)
//   block1_bwd_weight <- _bwd2_kernel  (:235), dW [C, 1, 3, 3] and dbias [C]
// Like the TPU kernels, none of them writes the [B, C, F, T] conv activation:
// the forward writes only the pooled [B, C, F/2, T/2] output, and both backward
// passes recompute the conv from x.
//
// What is computed (per channel c, per position (f, t), with x zero-padded by one):
//   y_raw = sum_{di,dj} w[c][di][dj] * x[f+di-1][t+dj-1] + bias[c]   (9 f32 FMAs)
//   forward:  out = max over the 2x2 window of relu(q * a + (b2 + bias * a)),
//             q = y_raw - bias (the TPU kernel folds the bias into the shift)
//   backward: bn = y_raw * a + b2; dy = dp routed to the window's FIRST maximum of
//             relu(bn) in the JAX package's time-major order (t0,f0), (t0,f1),
//             (t1,f0), (t1,f1) (ops/block1.py:188-213), times relu'(bn).
//             Pass 1 sums dy and dy * y_raw; pass 2 contracts
//             d_conv = k1 * dy + k2 * y_raw + k3 with the shifted x into dW and sums
//             it into dbias.
// Per-channel values come in as params [C, 16] f32: w[0..8] (the weights rounded
// to the stream dtype, as the TPU kernel's banded matrix is), bias, a, b2, k1,
// k2, k3. Inputs are f32 or bf16; every product is an f32 FFMA (bf16 operands are
// exact in f32), so there is no TF32 and no tensor-core rounding, and the conv
// feeds BN without a bf16 round trip (ops/block1.py:38-42).
//
// Design: one block of 256 threads per (clip, tile of R pooled rows). The block
// stages the tile's 2R + 2 input rows and the one-sample halo, zero-padded, in
// shared memory as f32, and the per-channel params beside them. Each warp takes
// channels warp, warp + 8, ...; its lanes walk the tile's pooled positions, so
// neighbouring lanes read neighbouring shared-memory columns and write
// neighbouring output addresses. For each pooled position a lane loads the 4 x 4
// input patch once and computes the four conv outputs of its window.
// The backward passes reduce across a warp with shuffles (a fixed order) and
// write one partial row per (block, channel) to a scratch tensor; a second
// kernel sums the partials over blocks in block order. No float atomics, so two
// runs give the same gradients bit for bit.
//
// Bound on an H100 SXM at one training view (B = 256, F = 64 mels, T = 96 frames,
// C = 64, bf16): the forward needs 256*64*64*96 = 100.7 M conv outputs x 9 MACs =
// 1.81 GFLOP and moves 3.1 MB of x in and 50.3 MB of pooled output out. At
// 3.35 TB/s the bytes take about 16 us; the operations take about 2 us at the
// 989 TFLOP/s bf16 rate (27 us as f32 FFMA at 67 TFLOP/s, which this design
// uses). So the function is bound by bytes. Backward pass 1 reads x and dp
// (53.4 MB, the same 16 us) and recomputes the 1.81 GFLOP; pass 2 adds the dW
// contraction, 3.6 GFLOP in all. This design is bound by shared-memory loads
// (16 per pooled position and channel, for 36 to 80 FMAs): a later PR can reuse
// patches across neighbouring positions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;  // pooled rows per block
constexpr int kParams = 16;  // per-channel f32 params
constexpr int kBias = 9, kA = 10, kB2 = 11, kK1 = 12, kK2 = 13, kK3 = 14;
constexpr size_t kSmemLimit = 48 * 1024;  // the default dynamic shared-memory limit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

size_t smem_bytes(int rows, int T, int C) {
    return ((size_t)(2 * rows + 2) * (T + 2) + (size_t)C * kParams) * sizeof(float);
}

// Pooled rows per block: at most kMaxRows and F/2, fewer for long clips so that
// the tile fits the default shared-memory limit; 0 if not even one row fits.
int rows_per_block(int F, int T, int C) {
    int r = kMaxRows < F / 2 ? kMaxRows : F / 2;
    while (r > 0 && smem_bytes(r, T, C) > kSmemLimit) --r;
    return r;
}

// Shared memory: params [C * kParams] | tile [(2R + 2) x (T + 2)]. Tile row r is
// input row f = 2 * p0 - 1 + r, tile column j is input column t = j - 1.
template <typename T_>
__device__ void stage(const T_* __restrict__ x, const float* __restrict__ params, float* prm,
                      float* tile, int b, int p0, int R, int F, int T, int C) {
    for (int i = threadIdx.x; i < C * kParams; i += blockDim.x) prm[i] = params[i];
    const int W = T + 2, H = 2 * R + 2;
    const T_* xb = x + (size_t)b * F * T;
    for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
        const int r = i / W, j = i - r * W;
        const int f = 2 * p0 - 1 + r, t = j - 1;
        tile[i] = (f >= 0 && f < F && t >= 0 && t < T) ? to_f32(xb[(size_t)f * T + t]) : 0.f;
    }
}

// The 4 x 4 input patch of pooled position (pr, q) of the tile.
__device__ __forceinline__ void load_patch(const float* tile, int W, int pr, int q, float p[4][4]) {
    const float* base = tile + (2 * pr) * W + 2 * q;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) p[u][v] = base[u * W + v];
}

// Window element k in the TPU kernel's quadrant order: (t0,f0), (t0,f1), (t1,f0), (t1,f1).
__device__ __forceinline__ int dfk(int k) { return k & 1; }
__device__ __forceinline__ int dtk(int k) { return k >> 1; }

// conv (no bias) of window element k.
__device__ __forceinline__ float conv_at(const float p[4][4], const float w[9], int k) {
    const int df = dfk(k), dt = dtk(k);
    float s = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) s = fmaf(w[di * 3 + dj], p[df + di][dt + dj], s);
    return s;
}

// Shared backward recompute: y_raw and the routed dy of the four window elements.
__device__ __forceinline__ void recompute_dy(const float p[4][4], const float w[9], float bias, float a,
                                             float b2, float dpv, float yr[4], float dy[4]) {
    float bn[4], o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        yr[k] = conv_at(p, w, k) + bias;
        bn[k] = yr[k] * a + b2;
        o[k] = fmaxf(bn[k], 0.f);
    }
    const float mx = fmaxf(fmaxf(o[0], o[1]), fmaxf(o[2], o[3]));
    bool taken = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const bool first = (o[k] == mx) && !taken;
        taken = taken || first;
        dy[k] = (first && bn[k] > 0.f) ? dpv : 0.f;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T_>
__global__ void __launch_bounds__(kThreads) block1_fwd_kernel(const T_* __restrict__ x, const float* __restrict__ params,
                                                              T_* __restrict__ out, int F, int T, int C, int R, int tiles) {
    extern __shared__ float smem[];
    float* prm = smem;
    float* tile = smem + C * kParams;
    const int b = blockIdx.x / tiles, p0 = (blockIdx.x - b * tiles) * R;
    stage(x, params, prm, tile, b, p0, R, F, T, C);
    __syncthreads();
    const int Fp = F / 2, Tp = T / 2, W = T + 2;
    const int rows = min(R, Fp - p0), npos = rows * Tp;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kWarps) {
        const float* pc = prm + c * kParams;
        float w[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) w[k] = pc[k];
        const float a = pc[kA], bapp = pc[kB2] + pc[kBias] * a;
        T_* oc = out + ((size_t)b * C + c) * Fp * Tp + (size_t)p0 * Tp;
        for (int pos = lane; pos < npos; pos += 32) {
            const int pr = pos / Tp, q = pos - pr * Tp;
            float p[4][4];
            load_patch(tile, W, pr, q, p);
            float o = 0.f;  // every candidate is a relu output, so 0 is the identity of the max
#pragma unroll
            for (int k = 0; k < 4; ++k) o = fmaxf(o, fmaxf(conv_at(p, w, k) * a + bapp, 0.f));
            store(oc + pos, o);
        }
    }
}

// kWeight = false: partial[blk][c] = (sum dy, sum dy * y_raw).
// kWeight = true:  partial[blk][c] = (dW[0..8], dbias) of d_conv = k1 dy + k2 y_raw + k3.
template <typename T_, bool kWeight>
__global__ void __launch_bounds__(kThreads) block1_bwd_kernel(const T_* __restrict__ x, const T_* __restrict__ dp,
                                                              const float* __restrict__ params, float* __restrict__ partial,
                                                              int F, int T, int C, int R, int tiles) {
    constexpr int kOut = kWeight ? 10 : 2;
    extern __shared__ float smem[];
    float* prm = smem;
    float* tile = smem + C * kParams;
    const int b = blockIdx.x / tiles, p0 = (blockIdx.x - b * tiles) * R;
    stage(x, params, prm, tile, b, p0, R, F, T, C);
    __syncthreads();
    const int Fp = F / 2, Tp = T / 2, W = T + 2;
    const int rows = min(R, Fp - p0), npos = rows * Tp;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int c = warp; c < C; c += kWarps) {
        const float* pc = prm + c * kParams;
        float w[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) w[k] = pc[k];
        const float bias = pc[kBias], a = pc[kA], b2 = pc[kB2];
        const float k1 = pc[kK1], k2 = pc[kK2], k3 = pc[kK3];
        const T_* dpc = dp + ((size_t)b * C + c) * Fp * Tp + (size_t)p0 * Tp;
        float acc[kOut];
#pragma unroll
        for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
        for (int pos = lane; pos < npos; pos += 32) {
            const int pr = pos / Tp, q = pos - pr * Tp;
            float p[4][4], yr[4], dy[4];
            load_patch(tile, W, pr, q, p);
            recompute_dy(p, w, bias, a, b2, to_f32(dpc[pos]), yr, dy);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                if constexpr (kWeight) {
                    const float dc = k1 * dy[k] + k2 * yr[k] + k3;
                    const int df = dfk(k), dt = dtk(k);
#pragma unroll
                    for (int di = 0; di < 3; ++di)
#pragma unroll
                        for (int dj = 0; dj < 3; ++dj)
                            acc[di * 3 + dj] = fmaf(dc, p[df + di][dt + dj], acc[di * 3 + dj]);
                    acc[9] += dc;
                } else {
                    acc[0] += dy[k];
                    acc[1] = fmaf(dy[k], yr[k], acc[1]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kOut; ++i) acc[i] = warp_sum(acc[i]);
        if (lane == 0) {
            float* dst = partial + ((size_t)blockIdx.x * C + c) * kOut;
#pragma unroll
            for (int i = 0; i < kOut; ++i) dst[i] = acc[i];
        }
    }
}

// out[i] = sum over blocks, in block order, of partial[blk][i].
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int nblk, int n, float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int k = 0; k < nblk; ++k) s += partial[(size_t)k * n + i];
    out[i] = s;
}

template <typename T_>
int launch_fwd(const void* x, int B, int F, int T, int C, const float* params, void* out, cudaStream_t stream) {
    const int R = rows_per_block(F, T, C);
    if (R == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (F / 2 + R - 1) / R;
    block1_fwd_kernel<T_><<<B * tiles, kThreads, smem_bytes(R, T, C), stream>>>(
        static_cast<const T_*>(x), params, static_cast<T_*>(out), F, T, C, R, tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename T_, bool kWeight>
int launch_bwd(const void* x, const void* dp, int B, int F, int T, int C, const float* params, float* partial,
               float* out, cudaStream_t stream) {
    const int R = rows_per_block(F, T, C);
    if (R == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (F / 2 + R - 1) / R;
    block1_bwd_kernel<T_, kWeight><<<B * tiles, kThreads, smem_bytes(R, T, C), stream>>>(
        static_cast<const T_*>(x), static_cast<const T_*>(dp), params, partial, F, T, C, R, tiles);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int n = C * (kWeight ? 10 : 2);
    reduce_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, B * tiles, n, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the backward passes for a [B, 1, F, T] input: the wrapper sizes the
// scratch tensor of partials [blocks, C, 2 or 10] with it. 0 if the clip is too
// long for one pooled row in shared memory.
extern "C" int audiossl_block1_blocks(int B, int F, int T, int C) {
    const int R = rows_per_block(F, T, C);
    return R == 0 ? 0 : B * ((F / 2 + R - 1) / R);
}

// x [B, 1, F, T] (bf16 if is_bf16, else f32), params [C, 16] f32 ->
// out [B, C, F/2, T/2] in x's dtype. F and T even. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int audiossl_block1_fwd(const void* x, int is_bf16, int B, int F, int T, int C, const float* params,
                                   void* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_fwd<__nv_bfloat16>(x, B, F, T, C, params, out, s)
                   : launch_fwd<float>(x, B, F, T, C, params, out, s);
}

// x [B, 1, F, T], dp [B, C, F/2, T/2] (both bf16 or both f32), params [C, 16] ->
// out [C, 2] f32 = (sum dy, sum dy * y_raw); partial [blocks, C, 2] is scratch.
extern "C" int audiossl_block1_bwd_sums(const void* x, const void* dp, int is_bf16, int B, int F, int T, int C,
                                        const float* params, float* partial, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_bwd<__nv_bfloat16, false>(x, dp, B, F, T, C, params, partial, out, s)
                   : launch_bwd<float, false>(x, dp, B, F, T, C, params, partial, out, s);
}

// As audiossl_block1_bwd_sums, -> out [C, 10] f32 = (dW[c, 0, di, dj] at di * 3 + dj, dbias);
// partial [blocks, C, 10] is scratch.
extern "C" int audiossl_block1_bwd_weight(const void* x, const void* dp, int is_bf16, int B, int F, int T, int C,
                                          const float* params, float* partial, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_bwd<__nv_bfloat16, true>(x, dp, B, F, T, C, params, partial, out, s)
                   : launch_bwd<float, true>(x, dp, B, F, T, C, params, partial, out, s);
}
