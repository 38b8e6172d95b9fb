// Native host-side loops of the port: FASTA scanning and encoding,
// hashed k-mer counting for the homology prefilter, and union-find over
// the hit graph.  The same code as the JAX package's native library, so
// the two packages read the same records and compute the same profiles
// and components bit for bit.  Bound with ctypes by
// pepr_tpu_torch/native/__init__.py, which builds it at first use:
//
//   g++ -O3 -shared -fPIC fastio.cpp -o _build/libpepr_fastio.so
//
// (no -march=native: the library gives the same bits on every host).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// FASTA: single pass over the file, returning sizes; second call fills
// caller-allocated buffers.  Codes use the caller-provided 256-entry
// lookup table (alphabet.ENCODE_LUT).
// ---------------------------------------------------------------------

int fasta_stats(const char* path, int64_t* n_seqs, int64_t* n_residues,
                int64_t* title_bytes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    std::vector<char> buf(1 << 20);
    int64_t seqs = 0, residues = 0, tbytes = 0;
    bool in_title = false, at_line_start = true;
    size_t got;
    while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
        for (size_t i = 0; i < got; i++) {
            // unsigned, as in fasta_parse: a byte of 0x80 or above is a
            // residue in both passes, so the count sizes the codes buffer
            unsigned char c = (unsigned char)buf[i];
            // '>' opens a record only at the start of a line (titles
            // can legally contain '>', e.g. "3'->5' exoribonuclease")
            if (c == '>' && at_line_start) {
                in_title = true; seqs++; at_line_start = false; continue;
            }
            if (c == '\n' || c == '\r') {
                in_title = false; at_line_start = true; continue;
            }
            at_line_start = false;
            if (in_title) tbytes++;
            else if (c > ' ') residues++;
        }
    }
    fclose(f);
    *n_seqs = seqs; *n_residues = residues; *title_bytes = tbytes + seqs;
    return 0;
}

int fasta_parse(const char* path, const int8_t* lut, int8_t* codes,
                int64_t* seq_offsets, char* titles,
                int64_t* title_offsets, int64_t n_seqs_expected) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    std::vector<char> buf(1 << 20);
    int64_t seq_i = -1, code_pos = 0, title_pos = 0;
    bool in_title = false, at_line_start = true;
    size_t got;
    while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
        for (size_t i = 0; i < got; i++) {
            unsigned char c = (unsigned char)buf[i];
            if (c == '>' && at_line_start) {
                seq_i++;
                if (seq_i >= n_seqs_expected) { fclose(f); return -2; }
                seq_offsets[seq_i] = code_pos;
                title_offsets[seq_i] = title_pos;
                in_title = true;
                at_line_start = false;
                continue;
            }
            if (c == '\n' || c == '\r') {
                if (in_title) { titles[title_pos++] = '\0'; }
                in_title = false;
                at_line_start = true;
                continue;
            }
            at_line_start = false;
            if (in_title) titles[title_pos++] = (char)c;
            else if (c > ' ') codes[code_pos++] = lut[c];
        }
    }
    if (in_title) titles[title_pos++] = '\0';
    seq_offsets[seq_i + 1] = code_pos;
    fclose(f);
    return (int)(seq_i + 1);
}

// ---------------------------------------------------------------------
// Hashed k-mer count profiles (ops/kmer_filter.kmer_profiles core):
// writes clipped, L2-normalized float32 rows.
// ---------------------------------------------------------------------

void kmer_profiles(const int8_t* codes, const int64_t* offsets,
                   int64_t n_seqs, int k, int dim, int clip,
                   int n_aa, float* out) {
    const uint64_t mult = 1099511628211ULL;
    std::vector<float> counts(dim);
    for (int64_t s = 0; s < n_seqs; s++) {
        int64_t a = offsets[s], b = offsets[s + 1];
        std::memset(counts.data(), 0, dim * sizeof(float));
        int64_t len = b - a;
        for (int64_t w = 0; w + k <= len; w++) {
            uint64_t h = 0;
            bool ok = true;
            for (int j = 0; j < k; j++) {
                int8_t c = codes[a + w + j];
                if (c >= n_aa) { ok = false; break; }
                h = h * mult + (uint64_t)c;
            }
            if (!ok) continue;
            h = (h ^ (h >> 29)) * mult;
            int bucket = (int)(h % (uint64_t)dim);
            if (counts[bucket] < clip) counts[bucket] += 1.0f;
        }
        double norm = 0;
        for (int d = 0; d < dim; d++) norm += counts[d] * counts[d];
        norm = norm > 0 ? 1.0 / std::sqrt(norm) : 0.0;
        float* row = out + s * dim;
        for (int d = 0; d < dim; d++) row[d] = (float)(counts[d] * norm);
    }
}

// ---------------------------------------------------------------------
// Union-find connected components over an edge list.
// ---------------------------------------------------------------------

static int64_t uf_find(std::vector<int64_t>& p, int64_t x) {
    int64_t root = x;
    while (p[root] != root) root = p[root];
    while (p[x] != root) { int64_t nxt = p[x]; p[x] = root; x = nxt; }
    return root;
}

void connected_components(int64_t n, const int64_t* ei, const int64_t* ej,
                          int64_t m, int64_t* comp) {
    std::vector<int64_t> p(n);
    for (int64_t i = 0; i < n; i++) p[i] = i;
    for (int64_t e = 0; e < m; e++) {
        int64_t a = uf_find(p, ei[e]), b = uf_find(p, ej[e]);
        if (a != b) p[b] = a;
    }
    for (int64_t i = 0; i < n; i++) comp[i] = uf_find(p, i);
}

}  // extern "C"
