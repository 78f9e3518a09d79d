// fastio: native contact-pair parsing and COO aggregation.
//
// The reference builds its sparse matrices with a Python dict-of-dicts loop
// over the raw pair list (abs_contact_2_coo_file, pyramid_sparse.py:222-264)
// — minutes for Hi-C libraries with 1e8 read pairs. This C++ path mmaps the
// file, parses the two leading integer columns of every line with branch-
// light scalar code, and aggregates duplicates with a sort + run-length
// pass. Exposed through a C ABI consumed via ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libfastio.so fastio.cpp
// (graal_tpu_torch.io.native_io builds it at first use into
// build/graal_tpu_torch/; a failed build raises).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct CooResult {
    int64_t *rows;
    int64_t *cols;
    int64_t *counts;
    int64_t n;       // number of unique pairs
    int64_t total;   // number of parsed input pairs
    int64_t max_id;  // largest fragment id seen (input basis)
};

// Parse a whitespace-separated pair file. ``one_based``: subtract 1 from the
// ids. ``weighted``: a third integer column is the pair count (COO files);
// otherwise every line counts once (raw pair lists). Skips the header line.
// Returns 0 on success.
int parse_pairs(const char *path, int one_based, int weighted,
                CooResult *out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return -1; }
    size_t len = (size_t)st.st_size;
    if (len == 0) { close(fd); out->rows = nullptr; out->cols = nullptr;
                    out->counts = nullptr; out->n = 0; out->total = 0;
                    out->max_id = -1; return 0; }
    const char *data = (const char *)mmap(nullptr, len, PROT_READ,
                                          MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) return -1;

    const char *p = data;
    const char *end = data + len;
    // skip header line
    while (p < end && *p != '\n') p++;
    if (p < end) p++;

    std::vector<uint64_t> keys;
    std::vector<int64_t> weights;
    keys.reserve(1 << 20);
    if (weighted) weights.reserve(1 << 20);
    int64_t max_id = -1;
    int64_t total = 0;
    bool bad = false;

    auto parse_int = [&](const char *&q) -> int64_t {
        while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
        bool neg = false;
        if (q < end && *q == '-') { neg = true; q++; }
        if (q >= end || *q < '0' || *q > '9') { bad = true; return -1; }
        int64_t v = 0;
        while (q < end && *q >= '0' && *q <= '9') v = v * 10 + (*q++ - '0');
        return neg ? -v : v;
    };

    while (p < end) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        int64_t a = parse_int(p);
        int64_t b = parse_int(p);
        int64_t w = 1;
        if (weighted) w = parse_int(p);
        if (bad) { munmap((void *)data, len); return -2; }
        if (one_based) { a -= 1; b -= 1; }
        if (a < 0 || b < 0) { munmap((void *)data, len); return -3; }
        if (a > b) std::swap(a, b);
        if (b > max_id) max_id = b;
        keys.push_back(((uint64_t)a << 32) | (uint64_t)b);
        if (weighted) weights.push_back(w);
        total += weighted ? w : 1;
        // to end of line (ignore extra columns)
        while (p < end && *p != '\n') p++;
    }
    munmap((void *)data, len);

    // aggregate duplicates
    size_t m = keys.size();
    int64_t n_unique = 0;
    int64_t *rows = nullptr, *cols = nullptr, *counts = nullptr;
    if (m > 0) {
        if (weighted) {
            std::vector<size_t> order(m);
            for (size_t i = 0; i < m; i++) order[i] = i;
            std::sort(order.begin(), order.end(),
                      [&](size_t x, size_t y) { return keys[x] < keys[y]; });
            rows = (int64_t *)malloc(m * sizeof(int64_t));
            cols = (int64_t *)malloc(m * sizeof(int64_t));
            counts = (int64_t *)malloc(m * sizeof(int64_t));
            uint64_t prev = ~keys[order[0]];
            for (size_t i = 0; i < m; i++) {
                uint64_t k = keys[order[i]];
                if (k != prev) {
                    rows[n_unique] = (int64_t)(k >> 32);
                    cols[n_unique] = (int64_t)(k & 0xffffffffu);
                    counts[n_unique] = 0;
                    n_unique++;
                    prev = k;
                }
                counts[n_unique - 1] += weights[order[i]];
            }
        } else {
            std::sort(keys.begin(), keys.end());
            rows = (int64_t *)malloc(m * sizeof(int64_t));
            cols = (int64_t *)malloc(m * sizeof(int64_t));
            counts = (int64_t *)malloc(m * sizeof(int64_t));
            uint64_t prev = ~keys[0];
            for (size_t i = 0; i < m; i++) {
                if (keys[i] != prev) {
                    rows[n_unique] = (int64_t)(keys[i] >> 32);
                    cols[n_unique] = (int64_t)(keys[i] & 0xffffffffu);
                    counts[n_unique] = 0;
                    n_unique++;
                    prev = keys[i];
                }
                counts[n_unique - 1] += 1;
            }
        }
    }
    out->rows = rows;
    out->cols = cols;
    out->counts = counts;
    out->n = n_unique;
    out->total = total;
    out->max_id = max_id;
    return 0;
}

void free_coo(CooResult *r) {
    free(r->rows);
    free(r->cols);
    free(r->counts);
    r->rows = r->cols = r->counts = nullptr;
    r->n = 0;
}

}  // extern "C"
