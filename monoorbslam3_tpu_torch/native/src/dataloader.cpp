// Native dataset loader: PNG/PNM decode + IMU text parse + a threaded
// in-order prefetcher (the port's copy of the JAX package's
// native/src/dataloader.cpp; host code, not a device kernel).
//
// The reference's dataset path is C++ (test/Data.h:14-49 loaders; demo
// mains decode with cv::imread on the tracking thread). A synchronous
// Python/PIL decode of a 752x480 PNG costs milliseconds on the frame's
// clock; this module decodes natively and ahead of the consumer on worker
// threads that never touch the GIL.
//
// Scope (deliberate): non-interlaced PNG, bit depth 1/2/4/8/16, color types
// gray / RGB / palette / gray+alpha / RGBA, and binary PGM/PPM; output =
// float32 grayscale (ITU-R 601 luma, matching PIL convert("L") within
// rounding). Adam7 or exotic chunks fall back to the Python path (the
// wrapper handles None).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

struct Gray {
    int w = 0, h = 0;
    std::vector<float> px;  // h*w luma in [0, 255]
    bool ok = false;
    std::string err;
};

inline uint32_t be32(const uint8_t *p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
    int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
        pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return (pb <= pc) ? b : c;
}

bool read_file(const std::string &path, std::vector<uint8_t> &out) {
    FILE *f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n < 0) {
        std::fclose(f);
        return false;
    }
    out.resize(size_t(n));
    size_t got = n ? std::fread(out.data(), 1, size_t(n), f) : 0;
    std::fclose(f);
    return got == size_t(n);
}

// expand a <8-bit packed sample row into bytes (per PNG spec, left-to-right
// most-significant bits first); `scale` maps the max code to 255
void unpack_bits(const uint8_t *in, int depth, int count, uint8_t *out) {
    int per = 8 / depth, mask = (1 << depth) - 1;
    int scale = 255 / mask;
    for (int i = 0; i < count; ++i) {
        int byte = in[i / per];
        int shift = 8 - depth * (i % per + 1);
        out[i] = uint8_t(((byte >> shift) & mask) * scale);
    }
}

Gray decode_png(const std::vector<uint8_t> &buf) {
    Gray g;
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (buf.size() < 8 || std::memcmp(buf.data(), sig, 8) != 0) {
        g.err = "not a png";
        return g;
    }
    size_t pos = 8;
    int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
    std::vector<uint8_t> idat;
    std::vector<uint8_t> plte;  // rgb triples
    bool ihdr = false, iend = false;
    while (pos + 8 <= buf.size() && !iend) {
        uint32_t len = be32(&buf[pos]);
        if (pos + 12 + size_t(len) > buf.size()) {
            g.err = "truncated chunk";
            return g;
        }
        const char *tag = reinterpret_cast<const char *>(&buf[pos + 4]);
        const uint8_t *data = &buf[pos + 8];
        if (!std::memcmp(tag, "IHDR", 4)) {
            if (len < 13) {
                g.err = "bad IHDR";
                return g;
            }
            w = int(be32(data));
            h = int(be32(data + 4));
            depth = data[8];
            ctype = data[9];
            interlace = data[12];
            ihdr = true;
        } else if (!std::memcmp(tag, "PLTE", 4)) {
            plte.assign(data, data + len);
        } else if (!std::memcmp(tag, "IDAT", 4)) {
            idat.insert(idat.end(), data, data + len);
        } else if (!std::memcmp(tag, "IEND", 4)) {
            iend = true;
        }
        pos += 12 + size_t(len);  // len + tag + data + crc
    }
    if (!ihdr || w <= 0 || h <= 0 || w > 1 << 20 || h > 1 << 20) {
        g.err = "missing/bad IHDR";
        return g;
    }
    if (interlace != 0) {
        g.err = "interlaced png unsupported";
        return g;
    }
    int channels;
    switch (ctype) {
        case 0: channels = 1; break;  // gray
        case 2: channels = 3; break;  // rgb
        case 3: channels = 1; break;  // palette index
        case 4: channels = 2; break;  // gray + alpha
        case 6: channels = 4; break;  // rgba
        default: g.err = "bad color type"; return g;
    }
    if (depth != 8 && depth != 16 &&
        !((ctype == 0 || ctype == 3) && (depth == 1 || depth == 2 || depth == 4))) {
        g.err = "bad bit depth";
        return g;
    }

    // inflate all IDAT data
    size_t row_bytes = (size_t(w) * channels * depth + 7) / 8;
    size_t raw_size = (row_bytes + 1) * size_t(h);
    std::vector<uint8_t> raw(raw_size);
    z_stream zs{};
    if (inflateInit(&zs) != Z_OK) {
        g.err = "zlib init";
        return g;
    }
    zs.next_in = idat.data();
    zs.avail_in = uInt(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = uInt(raw.size());
    int zret = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if ((zret != Z_STREAM_END && zret != Z_OK) || zs.total_out != raw_size) {
        g.err = "zlib inflate";
        return g;
    }

    // de-filter in place (scanline layout: filter byte + data)
    int bpp = std::max<size_t>(1, (size_t(channels) * depth) / 8);
    std::vector<uint8_t> prev(row_bytes, 0);
    std::vector<uint8_t> line(row_bytes);
    std::vector<uint8_t> unpacked;  // row of 8-bit samples when depth < 8
    if (depth < 8) unpacked.resize(size_t(w));

    g.w = w;
    g.h = h;
    g.px.resize(size_t(w) * h);
    const uint8_t *src = raw.data();
    for (int y = 0; y < h; ++y) {
        int filt = src[0];
        std::memcpy(line.data(), src + 1, row_bytes);
        src += row_bytes + 1;
        switch (filt) {
            case 0: break;
            case 1:
                for (size_t i = bpp; i < row_bytes; ++i) line[i] += line[i - bpp];
                break;
            case 2:
                for (size_t i = 0; i < row_bytes; ++i) line[i] += prev[i];
                break;
            case 3:
                for (size_t i = 0; i < row_bytes; ++i) {
                    int a = i >= size_t(bpp) ? line[i - bpp] : 0;
                    line[i] = uint8_t(line[i] + ((a + prev[i]) >> 1));
                }
                break;
            case 4:
                for (size_t i = 0; i < row_bytes; ++i) {
                    int a = i >= size_t(bpp) ? line[i - bpp] : 0;
                    int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
                    line[i] = uint8_t(line[i] + paeth(a, prev[i], c));
                }
                break;
            default:
                g.err = "bad filter";
                g.px.clear();
                return g;
        }
        std::memcpy(prev.data(), line.data(), row_bytes);

        float *dst = &g.px[size_t(y) * w];
        const uint8_t *s = line.data();
        if (depth < 8) {
            unpack_bits(s, depth, w, unpacked.data());
            s = unpacked.data();
        }
        // specialized per-(ctype, depth) loops: the generic branchy form
        // measured 3x slower than PIL's C decoder; these auto-vectorize
        if (ctype == 0 && depth == 8) {
            for (int x = 0; x < w; ++x) dst[x] = float(s[x]);
        } else if (ctype == 2 && depth == 8) {
            for (int x = 0; x < w; ++x)
                dst[x] = 0.299f * s[3 * x] + 0.587f * s[3 * x + 1] +
                         0.114f * s[3 * x + 2];
        } else if (ctype == 6 && depth == 8) {
            for (int x = 0; x < w; ++x)
                dst[x] = 0.299f * s[4 * x] + 0.587f * s[4 * x + 1] +
                         0.114f * s[4 * x + 2];
        } else if (ctype == 4 && depth == 8) {
            for (int x = 0; x < w; ++x) dst[x] = float(s[2 * x]);
        } else if (ctype == 3) {  // palette (index already 8-bit)
            for (int x = 0; x < w; ++x) {
                size_t pi = size_t(s[x]) * 3;
                dst[x] = pi + 2 < plte.size()
                             ? 0.299f * plte[pi] + 0.587f * plte[pi + 1] +
                                   0.114f * plte[pi + 2]
                             : 0.0f;
            }
        } else if (ctype == 0 && depth < 8) {
            for (int x = 0; x < w; ++x) dst[x] = float(s[x]);
        } else {  // 16-bit: high (big-endian first) byte = full-range >> 8
            int step = channels * 2;
            for (int x = 0; x < w; ++x) {
                const uint8_t *p = s + size_t(x) * step;
                dst[x] = (channels >= 3)
                             ? 0.299f * p[0] + 0.587f * p[2] + 0.114f * p[4]
                             : float(p[0]);
            }
        }
    }
    g.ok = true;
    return g;
}

// binary PGM (P5) / PPM (P6)
Gray decode_pnm(const std::vector<uint8_t> &buf) {
    Gray g;
    if (buf.size() < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6')) {
        g.err = "not pnm";
        return g;
    }
    int channels = buf[1] == '5' ? 1 : 3;
    size_t pos = 2;
    long vals[3];
    for (int i = 0; i < 3; ++i) {
        // skip whitespace + comments
        while (pos < buf.size() &&
               (isspace(buf[pos]) || buf[pos] == '#')) {
            if (buf[pos] == '#')
                while (pos < buf.size() && buf[pos] != '\n') ++pos;
            else
                ++pos;
        }
        long v = 0;
        bool any = false;
        while (pos < buf.size() && isdigit(buf[pos])) {
            v = v * 10 + (buf[pos++] - '0');
            any = true;
        }
        if (!any) {
            g.err = "bad pnm header";
            return g;
        }
        vals[i] = v;
    }
    ++pos;  // single whitespace after maxval
    int w = int(vals[0]), h = int(vals[1]);
    long maxv = vals[2];
    int bytes = maxv > 255 ? 2 : 1;
    size_t need = size_t(w) * h * channels * bytes;
    if (w <= 0 || h <= 0 || pos + need > buf.size()) {
        g.err = "truncated pnm";
        return g;
    }
    g.w = w;
    g.h = h;
    g.px.resize(size_t(w) * h);
    const uint8_t *s = &buf[pos];
    float scale = 255.0f / float(maxv);
    for (size_t i = 0; i < size_t(w) * h; ++i) {
        auto smp = [&](int c) -> float {
            const uint8_t *p = s + (i * channels + c) * bytes;
            return float(bytes == 2 ? (int(p[0]) << 8 | p[1]) : p[0]) * scale;
        };
        g.px[i] = channels == 1
                      ? smp(0)
                      : 0.299f * smp(0) + 0.587f * smp(1) + 0.114f * smp(2);
    }
    g.ok = true;
    return g;
}

Gray decode_path(const std::string &path) {
    std::vector<uint8_t> buf;
    if (!read_file(path, buf)) {
        Gray g;
        g.err = "cannot read " + path;
        return g;
    }
    if (buf.size() >= 8 && buf[0] == 137 && buf[1] == 'P') return decode_png(buf);
    return decode_pnm(buf);
}

// ---------------------------------------------------------------------------
// Python: load_gray(path) -> (h, w, bytes float32) | raises ValueError
// ---------------------------------------------------------------------------

PyObject *py_load_gray(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    Gray g;
    Py_BEGIN_ALLOW_THREADS
    g = decode_path(path);
    Py_END_ALLOW_THREADS
    if (!g.ok) {
        PyErr_Format(PyExc_ValueError, "decode %s: %s", path, g.err.c_str());
        return nullptr;
    }
    PyObject *bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(g.px.data()),
        Py_ssize_t(g.px.size() * sizeof(float)));
    if (!bytes) return nullptr;
    return Py_BuildValue("(iiN)", g.h, g.w, bytes);
}

// ---------------------------------------------------------------------------
// IMU text parse: rows "t gx gy gz ax ay az", strictly increasing t
// (test/Data.h:29-49) -> bytes of double[N*7]
// ---------------------------------------------------------------------------

PyObject *py_parse_imu(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    std::vector<double> rows;
    bool ok = true;
    Py_BEGIN_ALLOW_THREADS
    {
        FILE *f = std::fopen(path, "rb");
        if (!f) {
            ok = false;
        } else {
            char *line = nullptr;
            size_t cap = 0;
            double last_t = -HUGE_VAL;
            ssize_t n;
            while ((n = getline(&line, &cap, f)) >= 0) {
                const char *p = line;
                double v[7];
                int got = 0;
                while (got < 7) {
                    char *end;
                    double x = std::strtod(p, &end);
                    if (end == p) break;
                    v[got++] = x;
                    p = end;
                }
                if (got == 7 && v[0] > last_t) {
                    last_t = v[0];
                    rows.insert(rows.end(), v, v + 7);
                }
            }
            free(line);
            std::fclose(f);
        }
    }
    Py_END_ALLOW_THREADS
    if (!ok) {
        PyErr_Format(PyExc_ValueError, "cannot read %s", path);
        return nullptr;
    }
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(rows.data()),
        Py_ssize_t(rows.size() * sizeof(double)));
}

// ---------------------------------------------------------------------------
// Prefetcher: worker threads decode ahead, frames delivered in order.
// Workers are pure C++ (no Python API) and run GIL-free; next() releases
// the GIL while blocking.
// ---------------------------------------------------------------------------

struct Prefetcher {
    std::vector<std::string> paths;
    size_t depth;
    std::vector<std::thread> workers;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::map<size_t, Gray> done;
    std::atomic<size_t> next_fetch{0};
    size_t next_deliver = 0;
    bool closing = false;

    Prefetcher(std::vector<std::string> p, int n_workers, size_t d)
        : paths(std::move(p)), depth(d) {
        int n = std::max(1, n_workers);
        for (int i = 0; i < n; ++i)
            workers.emplace_back([this] { work(); });
    }

    void work() {
        for (;;) {
            size_t idx = next_fetch.fetch_add(1);
            if (idx >= paths.size()) return;
            {
                // bound how far ahead of the consumer we run
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] {
                    return closing || idx < next_deliver + depth;
                });
                if (closing) return;
            }
            Gray g = decode_path(paths[idx]);
            {
                std::lock_guard<std::mutex> lk(mu);
                done.emplace(idx, std::move(g));
            }
            cv_ready.notify_all();
        }
    }

    // returns false at end of sequence
    bool next(Gray &out) {
        std::unique_lock<std::mutex> lk(mu);
        if (next_deliver >= paths.size()) return false;
        cv_ready.wait(lk, [&] { return done.count(next_deliver) != 0; });
        auto it = done.find(next_deliver);
        out = std::move(it->second);
        done.erase(it);
        ++next_deliver;
        cv_space.notify_all();
        return true;
    }

    ~Prefetcher() {
        {
            std::lock_guard<std::mutex> lk(mu);
            closing = true;
            next_deliver = paths.size();  // release bounded waiters
        }
        cv_space.notify_all();
        for (auto &t : workers) t.join();
    }
};

void capsule_destroy(PyObject *cap) {
    auto *p = static_cast<Prefetcher *>(
        PyCapsule_GetPointer(cap, "monoslam.prefetcher"));
    delete p;
}

PyObject *py_prefetch_open(PyObject *, PyObject *args) {
    PyObject *list;
    int workers, depth;
    if (!PyArg_ParseTuple(args, "Oii", &list, &workers, &depth)) return nullptr;
    PyObject *seq = PySequence_Fast(list, "paths must be a sequence");
    if (!seq) return nullptr;
    std::vector<std::string> paths;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    paths.reserve(size_t(n));
    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        const char *s = PyUnicode_AsUTF8(it);
        if (!s) {
            Py_DECREF(seq);
            return nullptr;
        }
        paths.emplace_back(s);
    }
    Py_DECREF(seq);
    auto *p = new Prefetcher(std::move(paths), workers, size_t(std::max(1, depth)));
    return PyCapsule_New(p, "monoslam.prefetcher", capsule_destroy);
}

PyObject *py_prefetch_next(PyObject *, PyObject *args) {
    PyObject *cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
    auto *p = static_cast<Prefetcher *>(
        PyCapsule_GetPointer(cap, "monoslam.prefetcher"));
    if (!p) return nullptr;
    Gray g;
    bool more;
    Py_BEGIN_ALLOW_THREADS
    more = p->next(g);
    Py_END_ALLOW_THREADS
    if (!more) Py_RETURN_NONE;
    if (!g.ok) {
        // deliver the failure as (0, 0, err) so the wrapper can fall back
        return Py_BuildValue("(iis)", 0, 0, g.err.c_str());
    }
    PyObject *bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(g.px.data()),
        Py_ssize_t(g.px.size() * sizeof(float)));
    if (!bytes) return nullptr;
    return Py_BuildValue("(iiN)", g.h, g.w, bytes);
}

PyMethodDef methods[] = {
    {"load_gray", py_load_gray, METH_VARARGS,
     "decode png/pnm to (h, w, float32-bytes) grayscale"},
    {"parse_imu", py_parse_imu, METH_VARARGS,
     "parse 't gx gy gz ax ay az' rows -> float64 bytes [N*7]"},
    {"prefetch_open", py_prefetch_open, METH_VARARGS,
     "start a threaded in-order image prefetcher over a path list"},
    {"prefetch_next", py_prefetch_next, METH_VARARGS,
     "next (h, w, float32-bytes) frame, (0, 0, err) on decode failure, "
     "None at end"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "dataloader",
    "native dataset loader (png decode + imu parse + prefetch)", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_dataloader(void) { return PyModule_Create(&module); }
