// Native host-side map bookkeeping (the C++ of the JAX package's
// native/src/map_ops.cpp, kept here so the port builds its own).
//
// The reference implements its map bookkeeping in C++ behind mutexes
// (modules/BasicObject/KeyFrame.cpp:225-291 covisibility,
// LocalMapping.cpp:318-372 keyframe-redundancy scan). These host-side graph
// scans over the MapStore's struct-of-arrays buffers are a CPython
// extension (zero-copy); every function has a numpy fallback in
// native/__init__.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

namespace {

struct ArrayView {
    PyObject *obj = nullptr;
    Py_buffer view{};
    bool ok = false;

    ArrayView(PyObject *o, const char *name) {
        if (PyObject_GetBuffer(o, &view, PyBUF_C_CONTIGUOUS) != 0) {
            PyErr_Format(PyExc_TypeError, "%s: need a C-contiguous buffer", name);
            return;
        }
        obj = o;
        ok = true;
    }
    ~ArrayView() {
        if (ok) PyBuffer_Release(&view);
    }
    const int32_t *i32() const { return static_cast<const int32_t *>(view.buf); }
    Py_ssize_t nbytes() const { return view.len; }
};

// covis_counts(pt_ids, pt_obs_kf, pt_obs_n, max_obs, max_kf, exclude_kf)
//   -> bytes of int32[max_kf]: number of shared points with every other KF.
PyObject *covis_counts(PyObject *, PyObject *args) {
    PyObject *pt_ids_o, *obs_kf_o, *obs_n_o;
    int max_obs, max_kf, exclude_kf;
    if (!PyArg_ParseTuple(args, "OOOiii", &pt_ids_o, &obs_kf_o, &obs_n_o,
                          &max_obs, &max_kf, &exclude_kf))
        return nullptr;
    ArrayView pt_ids(pt_ids_o, "pt_ids");
    ArrayView obs_kf(obs_kf_o, "pt_obs_kf");
    ArrayView obs_n(obs_n_o, "pt_n_obs");
    if (!pt_ids.ok || !obs_kf.ok || !obs_n.ok) return nullptr;

    const int32_t *ids = pt_ids.i32();
    const int32_t *okf = obs_kf.i32();
    const int32_t *on = obs_n.i32();
    Py_ssize_t n = pt_ids.nbytes() / 4;

    std::vector<int32_t> counts(static_cast<size_t>(max_kf), 0);
    for (Py_ssize_t i = 0; i < n; ++i) {
        int32_t p = ids[i];
        if (p < 0) continue;
        int32_t m = on[p];
        const int32_t *row = okf + static_cast<int64_t>(p) * max_obs;
        for (int32_t j = 0; j < m; ++j) {
            int32_t kf = row[j];
            if (kf >= 0 && kf != exclude_kf && kf < max_kf) counts[kf]++;
        }
    }
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(counts.data()),
        static_cast<Py_ssize_t>(counts.size() * 4));
}

// redundancy_count(feat_pt_row, feat_level_row, pt_obs_kf, pt_obs_feat,
//                  pt_n_obs, kf_feat_level_flat, n_feat, max_obs, self_kf)
//   -> (n_checked, n_redundant): a feature is redundant when its point is
//   seen by >= 3 other KFs at scale level <= level + 1
//   (the 90% rule's inner scan, LocalMapping.cpp:318-372).
PyObject *redundancy_count(PyObject *, PyObject *args) {
    PyObject *fp_o, *fl_o, *okf_o, *ofe_o, *on_o, *kfl_o;
    int n_feat, max_obs, self_kf;
    if (!PyArg_ParseTuple(args, "OOOOOOiii", &fp_o, &fl_o, &okf_o, &ofe_o,
                          &on_o, &kfl_o, &n_feat, &max_obs, &self_kf))
        return nullptr;
    ArrayView fp(fp_o, "feat_pt");
    ArrayView fl(fl_o, "feat_level");
    ArrayView okf(okf_o, "pt_obs_kf");
    ArrayView ofe(ofe_o, "pt_obs_feat");
    ArrayView on(on_o, "pt_n_obs");
    ArrayView kfl(kfl_o, "kf_feat_level");
    if (!fp.ok || !fl.ok || !okf.ok || !ofe.ok || !on.ok || !kfl.ok)
        return nullptr;

    const int32_t *feat_pt = fp.i32();
    const int32_t *feat_level = fl.i32();
    const int32_t *obs_kf = okf.i32();
    const int32_t *obs_feat = ofe.i32();
    const int32_t *n_obs = on.i32();
    const int32_t *kf_levels = kfl.i32();

    long checked = 0, redundant = 0;
    for (int f = 0; f < n_feat; ++f) {
        int32_t p = feat_pt[f];
        if (p < 0) continue;
        ++checked;
        int32_t lv = feat_level[f];
        int better = 0;
        int32_t m = n_obs[p];
        const int32_t *rk = obs_kf + static_cast<int64_t>(p) * max_obs;
        const int32_t *rf = obs_feat + static_cast<int64_t>(p) * max_obs;
        for (int32_t j = 0; j < m && better < 3; ++j) {
            int32_t kj = rk[j];
            if (kj < 0 || kj == self_kf) continue;
            int32_t flj = kf_levels[static_cast<int64_t>(kj) * n_feat + rf[j]];
            if (flj <= lv + 1) ++better;
        }
        if (better >= 3) ++redundant;
    }
    return Py_BuildValue("(ll)", checked, redundant);
}

PyMethodDef methods[] = {
    {"covis_counts", covis_counts, METH_VARARGS,
     "shared-point counts between a keyframe's points and all other KFs"},
    {"redundancy_count", redundancy_count, METH_VARARGS,
     "keyframe-culling redundancy statistics"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "map_ops",
    "native map bookkeeping kernels", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_map_ops(void) { return PyModule_Create(&module); }
