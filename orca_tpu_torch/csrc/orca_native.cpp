// orca_native: host-side codec of the orca_tpu_torch data path.
//
// The reference relies on native code in dependencies for its data layer:
// selene_sdk's Cython base->one-hot encoder, pyfaidx/htslib FASTA access,
// and a float32 one-hot genome memmap (selene_utils2.py:38-151; 16 bytes/bp,
// 47 GB for hg38). The genome stores one uint8 base code per bp (~3 GB) and
// these C++ functions do the hot host-side conversions that feed the card's
// input pipeline:
//   * fasta_to_codes: streaming FASTA -> code buffer (A=0 C=1 G=2 T=3 N=4)
//   * codes_to_onehot: codes -> float32 one-hot (0.25 for unknown)
//   * codes_to_onehot_rc: reverse-complement variant
//   * onehot_batch_gather: multi-window batched gather + expansion
//
// A copy of the JAX package's codec with the same four entry points and the
// same bytes out. Host code, not a kernel for the card: built with the host's
// C++ compiler on first use (ops/kernels/build.py), exposed with C linkage
// and consumed through ctypes (orca_tpu_torch/data/native.py); a numpy path
// exists for every entry point.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Base -> code lookup. 256 entries; acgtACGT mapped, everything else 4.
static uint8_t CODE_LUT[256];
static bool lut_init_done = false;

static void init_lut() {
    if (lut_init_done) return;
    memset(CODE_LUT, 4, sizeof(CODE_LUT));
    CODE_LUT[(unsigned)'A'] = 0; CODE_LUT[(unsigned)'a'] = 0;
    CODE_LUT[(unsigned)'C'] = 1; CODE_LUT[(unsigned)'c'] = 1;
    CODE_LUT[(unsigned)'G'] = 2; CODE_LUT[(unsigned)'g'] = 2;
    CODE_LUT[(unsigned)'T'] = 3; CODE_LUT[(unsigned)'t'] = 3;
    lut_init_done = true;
}

// Parse a FASTA stream into `out` (caller-allocated, >= file size), writing
// sequence codes contiguously. Records chromosome boundaries into
// offsets/name_buf. Returns the number of chromosomes, or -1 on error.
//   out        : uint8 code buffer
//   offsets    : int64 buffer of (2 * max_chroms): [start, end] pairs
//   name_buf   : char buffer (max_chroms * 256), NUL-separated names
long long fasta_to_codes(const char* path, uint8_t* out, int64_t* offsets,
                         char* name_buf, long long max_chroms) {
    init_lut();
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    static const size_t BUF = 1 << 20;
    char* buf = new char[BUF];
    long long nchrom = -1;
    long long pos = 0;
    char* name_out = name_buf;
    bool in_header = false;
    bool header_name_done = false;
    size_t got;
    while ((got = fread(buf, 1, BUF, f)) > 0) {
        for (size_t i = 0; i < got; i++) {
            char c = buf[i];
            if (c == '>') {
                if (nchrom >= 0) offsets[2 * nchrom + 1] = pos;
                nchrom++;
                if (nchrom >= max_chroms) { delete[] buf; fclose(f); return -2; }
                offsets[2 * nchrom] = pos;
                in_header = true;
                header_name_done = false;
                continue;
            }
            if (in_header) {
                // a '\r' before the header's '\n' is kept in the name when no
                // blank precedes it (">chr1\r\n" names "chr1\r")
                if (c == '\n') { in_header = false; *name_out++ = '\0'; }
                else if (c == ' ' || c == '\t') { header_name_done = true; }
                else if (!header_name_done) { *name_out++ = c; }
                continue;
            }
            if (c == '\n' || c == '\r') continue;
            out[pos++] = CODE_LUT[(unsigned char)c];
        }
    }
    if (nchrom >= 0) offsets[2 * nchrom + 1] = pos;
    delete[] buf;
    fclose(f);
    return nchrom + 1;
}

// codes (n,) -> one-hot float32 (n, 4); unknown (code 4, and any code above
// it) -> 0.25 each.
void codes_to_onehot(const uint8_t* codes, long long n, float* out) {
    static const float ROWS[5][4] = {
        {1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1},
        {0.25f, 0.25f, 0.25f, 0.25f},
    };
    for (long long i = 0; i < n; i++) {
        const float* r = ROWS[codes[i] > 4 ? 4 : codes[i]];
        float* o = out + 4 * i;
        o[0] = r[0]; o[1] = r[1]; o[2] = r[2]; o[3] = r[3];
    }
}

// Reverse-complement one-hot: out[i] = onehot(comp(codes[n-1-i])).
// comp(c) = 3 - c for ACGT; N stays N. Equivalent to the double flip
// encoding[::-1, ::-1] used throughout the reference.
void codes_to_onehot_rc(const uint8_t* codes, long long n, float* out) {
    static const float ROWS[5][4] = {
        {1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1},
        {0.25f, 0.25f, 0.25f, 0.25f},
    };
    for (long long i = 0; i < n; i++) {
        uint8_t c = codes[n - 1 - i];
        const float* r = ROWS[c >= 4 ? 4 : 3 - c];
        float* o = out + 4 * i;
        o[0] = r[0]; o[1] = r[1]; o[2] = r[2]; o[3] = r[3];
    }
}

// Batched window gather: for each window w, expand
// genome[starts[w] : starts[w] + window_len] into out[w], with optional
// reverse complement (strands[w] != 0) and 0.25 padding out of bounds.
void onehot_batch_gather(const uint8_t* genome, long long genome_len,
                         const int64_t* starts, const uint8_t* strands,
                         long long n_windows, long long window_len,
                         float* out) {
    for (long long w = 0; w < n_windows; w++) {
        float* dst = out + w * window_len * 4;
        long long s = starts[w];
        for (long long i = 0; i < window_len; i++) {
            long long src = strands[w] ? s + window_len - 1 - i : s + i;
            uint8_t c = 4;
            if (src >= 0 && src < genome_len) {
                c = genome[src];
                if (strands[w] && c < 4) c = 3 - c;
            }
            float* o = dst + 4 * i;
            o[0] = o[1] = o[2] = o[3] = 0.0f;
            if (c >= 4) { o[0] = o[1] = o[2] = o[3] = 0.25f; }
            else o[c] = 1.0f;
        }
    }
}

}  // extern "C"
