// Fast whitespace-separated double parser for HARM dump bodies.
//
// TPU-native equivalent of the host-side text parsing the reference does in
// C++ (cuda_grmonty/harm_model.cpp:81-232 reads the dump with istringstream,
// one line at a time).  Here the whole body is parsed in parallel: the
// buffer is split at line boundaries into one chunk per thread and each
// chunk is scanned with strtod.
//
// Exposed as a tiny C ABI consumed from Python via ctypes
// (grmonty_tpu/models/harmio_native.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libharmio.so harmio.cpp -lpthread

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Parse doubles from [begin, end) into out; returns count written.
int64_t parse_chunk(const char *begin, const char *end, double *out, int64_t cap) {
    const char *p = begin;
    int64_t n = 0;
    while (p < end && n < cap) {
        char *next = nullptr;
        double v = strtod(p, &next);
        if (next == p) {  // non-numeric byte: skip it
            ++p;
            continue;
        }
        if (next > end) break;  // token straddles the chunk boundary: not ours
        out[n++] = v;
        p = next;
    }
    return n;
}

}  // namespace

extern "C" {

// Parse up to `cap` whitespace-separated doubles from text[0..len).
// Writes values into out (caller-allocated, length >= cap) and returns the
// number parsed, or -1 on error.  `n_threads` <= 0 picks hardware parallelism.
int64_t harmio_parse_doubles(const char *text, int64_t len, double *out, int64_t cap,
                             int32_t n_threads) {
    if (!text || !out || len < 0) return -1;

    int nt = n_threads > 0 ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
    if (nt < 1) nt = 1;
    if (len < (1 << 16)) nt = 1;  // small input: threading overhead not worth it

    // Chunk boundaries snapped forward to the next newline so every token is
    // wholly contained in exactly one chunk.
    std::vector<const char *> starts(nt + 1);
    starts[0] = text;
    starts[nt] = text + len;
    for (int i = 1; i < nt; ++i) {
        const char *p = text + (len * i) / nt;
        while (p < text + len && *p != '\n') ++p;
        starts[i] = p;
    }

    // Counting pass per chunk (cheap vs strtod) so outputs can be packed
    // without a second copy: count tokens first, then parse into offsets.
    std::vector<int64_t> counts(nt, 0);
    {
        std::vector<std::thread> threads;
        for (int i = 0; i < nt; ++i) {
            threads.emplace_back([&, i] {
                const char *p = starts[i];
                const char *e = starts[i + 1];
                int64_t c = 0;
                bool in_tok = false;
                while (p < e) {
                    bool ws = (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r');
                    if (!ws && !in_tok) ++c;
                    in_tok = !ws;
                    ++p;
                }
                counts[i] = c;
            });
        }
        for (auto &t : threads) t.join();
    }

    std::vector<int64_t> offsets(nt + 1, 0);
    for (int i = 0; i < nt; ++i) offsets[i + 1] = offsets[i] + counts[i];
    if (offsets[nt] > cap) return -1;

    std::vector<int64_t> written(nt, 0);
    {
        std::vector<std::thread> threads;
        for (int i = 0; i < nt; ++i) {
            threads.emplace_back([&, i] {
                written[i] =
                    parse_chunk(starts[i], starts[i + 1], out + offsets[i], counts[i]);
            });
        }
        for (auto &t : threads) t.join();
    }

    int64_t total = 0;
    for (int i = 0; i < nt; ++i) {
        if (written[i] != counts[i]) return -1;  // inconsistent count vs parse
        total += written[i];
    }
    return total;
}

}  // extern "C"
