// Dense spectrogram rows on Hopper: frame rows x window-folded DFT bank ->
// |.|^2 -> mel -> log, in one of two log modes.
//
// Replaces the TPU kernel audiossl_tpu/frontend/pallas_stft.py _fused_rows
// (pallas_call at :137, body _kernel at :80), which two functions reach:
//   kaldi_fbank_fused (:533), log mode "kaldi":   log(max(mel(power), EPS32)),
//     rows of 400 samples after DC removal and preemphasis, the symmetric
//     Hanning window folded into a 512-point real DFT bank, Kaldi mel banks
//     with the Nyquist column;
//   log_mel_fused (:99), log mode "librosa": log(mel(power + EPS64) + EPS32),
//     rows of n_fft samples, the periodic Hann folded into the DFT bank.
// Framing, DC removal and preemphasis run in plain torch before the kernel,
// as kaldi_fbank_fused does (pallas_stft.py:551-558); the kernel reads the
// [rows, win] frame matrix.
//
// Every product is full f32 FFMA: a TF32 or one-pass bf16 product misses the
// 1e-3 contract (the TPU's one-pass bf16 dot measured 1.7e-2 on the log-mel,
// pallas_stft.py:81-86).
//
// Design: one block per tile of R frame rows (R = 32 where shared memory
// allows, else 16 or 8). The block stages its rows transposed in shared
// memory ([win][R + 4], so a thread reads four rows with one float4), then
// thread j computes the real and imaginary part of bin j for all R rows: per
// tap it reads two bank values from global memory (the bank is read by every
// block, so it lives in L2) and does 2R FMAs. Power lands in shared memory;
// the epilogue applies each mel filter over its nonzero bin range, takes the
// log, and writes [rows, n_mels] row-major.
//
// Bound on an H100 SXM at the SS-MAST shape (64 clips x 998 frames = 63,872
// rows of 400 samples, 128 mels): the function reads 102.2 MB of frames and
// writes 32.7 MB (0.040 ms at 3.35 TB/s) and needs about 0.9 GFLOP (a real
// 512-point FFT at 2.5 N log2 N per frame plus window, power and the mel
// nonzeros), 0.013 ms at 67 TFLOP/s f32: bound by bytes. This dense design
// spends 2 x 400 x 514 FMA per row, 26.3 GFLOP (0.39 ms at the f32 peak),
// about 10x the bytes bound; an FFT in place of the dense DFT is the way
// closer, as for log_mel.cu.

#include <cuda_runtime.h>

namespace {

constexpr float kEps64 = 2.220446049250313e-16f;    // np.finfo(np.float64).eps
constexpr float kEps32 = 1.1920928955078125e-07f;   // np.finfo(np.float32).eps
constexpr int kMaxThreads = 544;                     // 17 warps: one thread per bin up to 544 bins
constexpr int kSmemLimit = 232448;                   // 227 KB per block on sm_90

template <int R>
__host__ __device__ inline int smem_bytes(int win, int n_bins) {
    return static_cast<int>(sizeof(float)) * (win * (R + 4) + R * n_bins);
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads)
fused_rows_kernel(const float* __restrict__ frames, int rows, int win, int n_bins, int n_mels,
                  const float* __restrict__ bank, const float* __restrict__ fb,
                  const int* __restrict__ mel_range, int librosa, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    constexpr int ld = R + 4;
    float* xt = smem;              // [win][ld]: the tile's rows, transposed
    float* pw = smem + win * ld;   // [R][n_bins]: power
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * R;

    for (int idx = tid; idx < R * win; idx += nt) {
        const int r = idx / win;
        const int k = idx - r * win;
        const long long row = row0 + r;
        xt[k * ld + r] = row < rows ? frames[row * win + k] : 0.0f;
    }
    __syncthreads();

    const long long ld_bank = 2LL * n_bins;
    for (int j = tid; j < n_bins; j += nt) {
        float re[R], im[R];
#pragma unroll
        for (int r = 0; r < R; ++r) re[r] = im[r] = 0.0f;
        const float* bc = bank + j;
        const float* bs = bank + n_bins + j;
        for (int k = 0; k < win; ++k) {
            const float c = __ldg(bc + k * ld_bank);
            const float s = __ldg(bs + k * ld_bank);
            const float4* xp = reinterpret_cast<const float4*>(xt + k * ld);
#pragma unroll
            for (int p = 0; p < R / 4; ++p) {
                const float4 x = xp[p];
                re[4 * p] = fmaf(x.x, c, re[4 * p]);
                im[4 * p] = fmaf(x.x, s, im[4 * p]);
                re[4 * p + 1] = fmaf(x.y, c, re[4 * p + 1]);
                im[4 * p + 1] = fmaf(x.y, s, im[4 * p + 1]);
                re[4 * p + 2] = fmaf(x.z, c, re[4 * p + 2]);
                im[4 * p + 2] = fmaf(x.z, s, im[4 * p + 2]);
                re[4 * p + 3] = fmaf(x.w, c, re[4 * p + 3]);
                im[4 * p + 3] = fmaf(x.w, s, im[4 * p + 3]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) pw[r * n_bins + j] = re[r] * re[r] + im[r] * im[r];
    }
    __syncthreads();

    for (int idx = tid; idx < R * n_mels; idx += nt) {
        const int r = idx / n_mels;
        const int i = idx - r * n_mels;
        const long long row = row0 + r;
        if (row >= rows) continue;
        const int lo = mel_range[2 * i];
        const int hi = mel_range[2 * i + 1];
        const float* w = fb + static_cast<long long>(i) * n_bins;
        const float* p = pw + r * n_bins;
        float acc = 0.0f;
        if (librosa) {
            for (int k = lo; k < hi; ++k) acc = fmaf(w[k], p[k] + kEps64, acc);
            out[row * n_mels + i] = logf(acc + kEps32);
        } else {
            for (int k = lo; k < hi; ++k) acc = fmaf(w[k], p[k], acc);
            out[row * n_mels + i] = logf(fmaxf(acc, kEps32));
        }
    }
}

template <int R>
int launch(const float* frames, int rows, int win, int n_bins, int n_mels, const float* bank,
           const float* fb, const int* mel_range, int librosa, float* out, cudaStream_t stream) {
    const int smem = smem_bytes<R>(win, n_bins);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fused_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int threads = (n_bins + 31) / 32 * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const int blocks = (rows + R - 1) / R;
    fused_rows_kernel<R><<<blocks, threads, smem, stream>>>(
        frames, rows, win, n_bins, n_mels, bank, fb, mel_range, librosa, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows per block the kernel takes for this width and bin count: 32, 16 or 8,
// or 0 when even 8 rows do not fit in shared memory.
extern "C" int audiossl_fused_rows_tile(int win, int n_bins) {
    if (smem_bytes<32>(win, n_bins) <= kSmemLimit) return 32;
    if (smem_bytes<16>(win, n_bins) <= kSmemLimit) return 16;
    if (smem_bytes<8>(win, n_bins) <= kSmemLimit) return 8;
    return 0;
}

// frames [rows, win] f32; bank [win, 2 * n_bins] f32 (cos columns, then
// sin); fb [n_mels, n_bins] f32; mel_range [n_mels, 2] int32 (first nonzero
// bin, one past the last); out [rows, n_mels] f32. librosa: 1 for the
// librosa log mode, 0 for Kaldi's. Returns cudaGetLastError() after the
// launch (0 on success); launches on `stream`, allocates nothing and does
// not synchronise.
extern "C" int audiossl_fused_rows(const float* frames, int rows, int win, int n_bins, int n_mels,
                                   const float* bank, const float* fb, const int* mel_range,
                                   int librosa, float* out, void* stream) {
    if (rows <= 0 || win <= 0 || n_bins <= 0 || n_mels <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (audiossl_fused_rows_tile(win, n_bins)) {
        case 32: return launch<32>(frames, rows, win, n_bins, n_mels, bank, fb, mel_range, librosa, out, s);
        case 16: return launch<16>(frames, rows, win, n_bins, n_mels, bank, fb, mel_range, librosa, out, s);
        case 8: return launch<8>(frames, rows, win, n_bins, n_mels, bank, fb, mel_range, librosa, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
