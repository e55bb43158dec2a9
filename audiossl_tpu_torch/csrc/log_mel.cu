// Fused librosa log-mel on Hopper: reflect-padded wave -> [B, n_mels, n_frames].
//
// Replaces the TPU kernels audiossl_tpu/frontend/pallas_stft.py
// log_mel_fused_ct2 (_ct2_kernel, in-kernel framing, bf16x3 dots) and
// log_mel_fused_ct (_ct_kernel, framing outside the kernel): one kernel
// computes the same function for every n_fft % 256 == 0 and any hop.
//
// Math (the TPU kernels' Cooley-Tukey factorization, n = 128*j + m,
// k = N2*t + r with N2 = n_fft/128):
//   B_r[m]        = sum_j xw[128 j + m] * W_N2^{j r}          (radix-N2 stage)
//   C_r[m]        = B_r[m] * W_n^{m r}                         (twiddle)
//   X[N2 t + r]   = sum_m C_r[m] * W_128^{m t}                 (128-point DFT)
// for residues r = 0 .. N2/2 only; the other rfft bins are conjugate
// mirrors of equal power. Each bin k in 0 .. n_fft/2 is written exactly once:
// directly from position (r, t) when k <= n_fft/2, or as the mirror
// n_fft - k when 1 <= r < N2/2 (the only residues with no direct position).
// Then power + EPS64, the Slaney filterbank over each mel's nonzero bin range,
// + EPS32 and the natural log. Everything is full f32 FFMA: no tensor cores,
// because a TF32 or one-pass bf16 product misses the 1e-3 librosa contract
// (the TPU's single-pass bf16 dot measured 1.7e-2, pallas_stft.py:81-86).
//
// Design: one block of 128 threads per (clip, tile of kFrames frames). The
// block stages the tile's sample span of the padded wave in shared memory
// (each frame is read straight from the wave, no [rows, n_fft] frame tensor
// exists in device memory), then for each residue r: thread m computes
// C_r[m] for every frame of the tile (window applied on the fly), and thread
// t computes X[N2 t + r] for every frame, reading C_r as broadcast float4s
// and the W_128 table from shared memory. Power lands in shared memory by
// bin; the mel + log epilogue writes [B, n_mels, n_frames] directly.
//
// Bound on an H100 SXM at the serving shape ([256, 15200] clips, n_fft 1024,
// hop 160, 64 mels, 24,576 frames): the function moves 15.6 MB of wave in
// and 6.3 MB of log-mel out (about 6.5 us at 3.35 TB/s) and needs about
// 0.76 GFLOP (a real 1024-point FFT is about 2.5 N log2 N = 25.6k FLOP per
// frame, plus window, power, the filterbank's 966 nonzeros and the log),
// about 11 us at the 67 TFLOP/s f32 non-tensor peak. So the function is
// bound by f32 operations at about 0.011 ms.
//
// This design spends far more than that: its 128-point DFTs take 513 bins x
// 128 complex MACs per frame, 13.7 GFLOP in all, about 0.2 ms at the same
// peak, so it cannot come within about 18x of the bound. An FFT stage in
// place of the 128-point DFT is the way closer. Within this design the inner
// loop is kept at 32 FFMA per 5 shared-memory loads (8 frames of
// accumulators per thread) so that the FMA pipe, not shared memory, limits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one thread per m in stage 1, per t in stage 2
constexpr int kFrames = 8;     // frames per block
constexpr float kEps64 = 2.220446049250313e-16f;    // np.finfo(np.float64).eps
constexpr float kEps32 = 1.1920928955078125e-07f;   // np.finfo(np.float32).eps

// Shared-memory layout (floats), every section 16-byte aligned:
//   wave [span_pad] | window [n_fft] | w128 [128 x float2] | c [128 x kFrames x float2]
//   | power [kFrames x n_bins]
__host__ __device__ inline int span_padded(int n_fft, int hop) {
    return (((kFrames - 1) * hop + n_fft) + 3) & ~3;
}

__host__ __device__ inline int smem_floats(int n_fft, int hop) {
    return span_padded(n_fft, hop) + n_fft + 2 * 128 + 2 * 128 * kFrames + kFrames * (n_fft / 2 + 1);
}

// consts (floats, built by the host wrapper):
//   window [n_fft] | w2 [N2][R][2] | tw [R][128][2] | w128 [128][2] | fb [n_mels][n_bins]
// mel_range [n_mels][2]: first nonzero bin, one past the last.
__global__ void __launch_bounds__(kThreads)
log_mel_ct_kernel(const float* __restrict__ wave, int padded_len, int n_frames, int tiles,
                  int n_fft, int hop, int n_mels,
                  const float* __restrict__ consts, const int* __restrict__ mel_range,
                  float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int n2 = n_fft / 128;
    const int r_max = n2 / 2 + 1;
    const int half = n_fft / 2;
    const int n_bins = half + 1;
    const int span = (kFrames - 1) * hop + n_fft;

    const float* g_window = consts;
    const float* g_w2 = g_window + n_fft;
    const float* g_tw = g_w2 + 2 * n2 * r_max;
    const float* g_w128 = g_tw + 2 * r_max * 128;
    const float* g_fb = g_w128 + 2 * 128;

    float* s_wave = smem;
    float* s_win = s_wave + span_padded(n_fft, hop);
    float2* s_w128 = reinterpret_cast<float2*>(s_win + n_fft);
    float2* s_c = s_w128 + 128;
    float* s_pow = reinterpret_cast<float*>(s_c + 128 * kFrames);

    const int b = blockIdx.x / tiles;
    const int frame0 = (blockIdx.x % tiles) * kFrames;
    const long long start = static_cast<long long>(frame0) * hop;
    const float* src = wave + static_cast<long long>(b) * padded_len;

    for (int i = tid; i < span; i += kThreads) {
        const long long idx = start + i;
        s_wave[i] = idx < padded_len ? src[idx] : 0.0f;
    }
    for (int i = tid; i < n_fft; i += kThreads) s_win[i] = g_window[i];
    s_w128[tid] = make_float2(g_w128[2 * tid], g_w128[2 * tid + 1]);
    __syncthreads();

    for (int r = 0; r < r_max; ++r) {
        // radix-N2 stage + twiddle: thread m, every frame of the tile
        {
            const int m = tid;
            const float twc = g_tw[2 * (r * 128 + m)];
            const float tws = g_tw[2 * (r * 128 + m) + 1];
            for (int f = 0; f < kFrames; ++f) {
                const float* x = s_wave + f * hop + m;
                float br = 0.0f, bi = 0.0f;
                for (int j = 0; j < n2; ++j) {
                    const float v = x[128 * j] * s_win[128 * j + m];
                    br = fmaf(v, g_w2[2 * (j * r_max + r)], br);
                    bi = fmaf(v, g_w2[2 * (j * r_max + r) + 1], bi);
                }
                s_c[m * kFrames + f] = make_float2(br * twc - bi * tws, br * tws + bi * twc);
            }
        }
        __syncthreads();

        // 128-point DFT: thread t owns position (r, t) for every frame
        {
            const int t = tid;
            const int k = n2 * t + r;
            const bool direct = k <= half;
            const bool mirror = !direct && r >= 1 && 2 * r < n2;
            if (direct || mirror) {
                const int bin = direct ? k : n_fft - k;
                float acc_re[kFrames], acc_im[kFrames];
#pragma unroll
                for (int f = 0; f < kFrames; ++f) acc_re[f] = acc_im[f] = 0.0f;
                for (int m = 0; m < 128; ++m) {
                    const float2 w = s_w128[(m * t) & 127];
                    const float4* cp = reinterpret_cast<const float4*>(s_c + m * kFrames);
#pragma unroll
                    for (int p = 0; p < kFrames / 2; ++p) {
                        const float4 c = cp[p];  // frames 2p (x, y) and 2p + 1 (z, w)
                        acc_re[2 * p] = fmaf(c.x, w.x, fmaf(-c.y, w.y, acc_re[2 * p]));
                        acc_im[2 * p] = fmaf(c.x, w.y, fmaf(c.y, w.x, acc_im[2 * p]));
                        acc_re[2 * p + 1] = fmaf(c.z, w.x, fmaf(-c.w, w.y, acc_re[2 * p + 1]));
                        acc_im[2 * p + 1] = fmaf(c.z, w.y, fmaf(c.w, w.x, acc_im[2 * p + 1]));
                    }
                }
#pragma unroll
                for (int f = 0; f < kFrames; ++f)
                    s_pow[f * n_bins + bin] = acc_re[f] * acc_re[f] + acc_im[f] * acc_im[f];
            }
        }
        __syncthreads();
    }

    // mel + log epilogue: (mel, frame) pairs, frames fastest for the store
    for (int idx = tid; idx < n_mels * kFrames; idx += kThreads) {
        const int i = idx / kFrames;
        const int f = idx % kFrames;
        const int frame = frame0 + f;
        if (frame >= n_frames) continue;
        const int lo = mel_range[2 * i];
        const int hi = mel_range[2 * i + 1];
        const float* w = g_fb + static_cast<long long>(i) * n_bins;
        const float* p = s_pow + f * n_bins;
        float acc = 0.0f;
        for (int k = lo; k < hi; ++k) acc = fmaf(w[k], p[k] + kEps64, acc);
        out[(static_cast<long long>(b) * n_mels + i) * n_frames + frame] = logf(acc + kEps32);
    }
}

}  // namespace

extern "C" int audiossl_log_mel_smem_bytes(int n_fft, int hop) {
    return static_cast<int>(sizeof(float)) * smem_floats(n_fft, hop);
}

// Returns cudaGetLastError() after the launch (0 on success). Launches on
// `stream`; allocates nothing and does not synchronise.
extern "C" int audiossl_log_mel(const float* wave, int batch, int padded_len, int n_frames,
                                int n_fft, int hop, int n_mels, const float* consts,
                                const int* mel_range, float* out, void* stream) {
    if (batch <= 0 || n_frames <= 0 || n_fft % 256 != 0 || hop <= 0 || n_mels <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = audiossl_log_mel_smem_bytes(n_fft, hop);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            log_mel_ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int tiles = (n_frames + kFrames - 1) / kFrames;
    log_mel_ct_kernel<<<batch * tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        wave, padded_len, n_frames, tiles, n_fft, hop, n_mels, consts, mel_range, out);
    return static_cast<int>(cudaGetLastError());
}
