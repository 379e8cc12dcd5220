/* Copied from gatekeeper_tpu/native/colext.c for the PyTorch port. */
/* Columnar ingest accelerator.
 *
 * The framework's "data loader": the hot host-side loops that flatten
 * JSON resource dicts into fixed-dtype columns (store/columns.py,
 * ir/prep.py) re-implemented against the CPython API.  The semantics
 * contract is the Python implementations — every function here has a
 * pure-Python twin that the test suite cross-checks; the extension is
 * an optional fast path loaded by gatekeeper_tpu/native/__init__.py
 * (which compiles this file on first use and falls back silently).
 *
 * Interning works directly on the Interner's internals (ids dict +
 * strings list) — same data structures, ~6x less interpreter dispatch.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>

#define MISSING (-1L)

/* ------------------------------------------------------------------ */

static long intern_str(PyObject *ids, PyObject *strings, PyObject *s)
{
    PyObject *hit = PyDict_GetItem(ids, s);          /* borrowed */
    if (hit != NULL)
        return PyLong_AsLong(hit);
    Py_ssize_t n = PyList_GET_SIZE(strings);
    PyObject *idx = PyLong_FromSsize_t(n);
    if (idx == NULL)
        return -2;
    if (PyDict_SetItem(ids, s, idx) < 0) {
        Py_DECREF(idx);
        return -2;
    }
    Py_DECREF(idx);
    if (PyList_Append(strings, s) < 0)
        return -2;
    return (long)n;
}

/* dict-only path walk; returns borrowed ref or NULL (absent). */
static PyObject *walk_path(PyObject *obj, PyObject *path, Py_ssize_t start)
{
    Py_ssize_t len = PyTuple_GET_SIZE(path);
    PyObject *cur = obj;
    for (Py_ssize_t i = start; i < len; i++) {
        if (!PyDict_Check(cur))
            return NULL;
        cur = PyDict_GetItem(cur, PyTuple_GET_ITEM(path, i));
        if (cur == NULL)
            return NULL;
    }
    return cur;
}

static int is_number(PyObject *v)
{
    return (PyLong_Check(v) || PyFloat_Check(v)) && !PyBool_Check(v);
}

/* Scalar value -> encoded-value interner key (ir/encode.py semantics):
 * returns new ref, or NULL with *compound=1 for compound values, or
 * NULL with error set. */
static PyObject *encode_scalar(PyObject *v, int *compound)
{
    *compound = 0;
    if (v == Py_None)
        return PyUnicode_FromStringAndSize("\x00" "z", 2);
    if (PyBool_Check(v))
        /* NB: separate literals — "\x00b" would parse as hex \x0b */
        return PyUnicode_FromStringAndSize(
            v == Py_True ? "\x00" "b:1" : "\x00" "b:0", 4);
    if (PyUnicode_Check(v)) {
        PyObject *prefix = PyUnicode_FromStringAndSize("\x00" "s:", 3);
        if (prefix == NULL)
            return NULL;
        PyObject *out = PyUnicode_Concat(prefix, v);
        Py_DECREF(prefix);
        return out;
    }
    if (PyLong_Check(v)) {
        PyObject *r = PyObject_Repr(v);
        if (r == NULL)
            return NULL;
        PyObject *prefix = PyUnicode_FromStringAndSize("\x00" "n:", 3);
        PyObject *out = PyUnicode_Concat(prefix, r);
        Py_DECREF(prefix);
        Py_DECREF(r);
        return out;
    }
    if (PyFloat_Check(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        PyObject *canon;
        if (isfinite(d) && d == floor(d) && fabs(d) < 9007199254740992.0)
            canon = PyLong_FromDouble(d);
        else
            canon = Py_NewRef(v);
        if (canon == NULL)
            return NULL;
        PyObject *r = PyObject_Repr(canon);
        Py_DECREF(canon);
        if (r == NULL)
            return NULL;
        PyObject *prefix = PyUnicode_FromStringAndSize("\x00" "n:", 3);
        PyObject *out = PyUnicode_Concat(prefix, r);
        Py_DECREF(prefix);
        Py_DECREF(r);
        return out;
    }
    *compound = 1;
    return NULL;
}

/* mode codes shared with native/__init__.py */
enum { M_STR = 0, M_VAL = 1, M_NUM = 2, M_LEN = 3, M_PRESENT = 4,
       M_TRUTHY = 5 };

/* Raw growable output buffer: cells are written as machine scalars
 * (int32 ids / float64 numbers / uint8 bools) instead of per-cell
 * PyObjects — the Python wrapper reinterprets the returned bytes with
 * np.frombuffer, so a 4M-element column costs one memcpy, not 4M
 * PyLong allocations plus a list->array conversion. */
typedef struct {
    char *p;
    Py_ssize_t len;   /* bytes used */
    Py_ssize_t cap;   /* bytes allocated */
    int item;         /* bytes per cell */
} Buf;

static int buf_init(Buf *b, Py_ssize_t cells, int item)
{
    if (cells < 16)
        cells = 16;
    b->p = PyMem_Malloc(cells * item);
    if (b->p == NULL) {
        PyErr_NoMemory();
        return -1;
    }
    b->len = 0;
    b->cap = cells * item;
    b->item = item;
    return 0;
}

static void *buf_more(Buf *b)
{
    if (b->len + b->item > b->cap) {
        Py_ssize_t cap = b->cap * 2;
        char *p = PyMem_Realloc(b->p, cap);
        if (p == NULL) {
            PyErr_NoMemory();
            return NULL;
        }
        b->p = p;
        b->cap = cap;
    }
    void *out = b->p + b->len;
    b->len += b->item;
    return out;
}

static int item_for_mode(int mode)
{
    switch (mode) {
    case M_STR: case M_VAL: return 4;           /* int32 ids */
    case M_NUM: case M_LEN: return 8;           /* float64 */
    default: return 1;                          /* uint8 bools */
    }
}

/* append one element-column cell for (elem, rel, mode).  Returns 0 ok. */
static int append_cell(Buf *col, PyObject *elem, PyObject *rel,
                       int mode, PyObject *ids, PyObject *strings,
                       PyObject *encode_cb)
{
    Py_ssize_t rlen = PyTuple_GET_SIZE(rel);
    PyObject *v = elem;
    int has = 1;
    for (Py_ssize_t i = 0; i < rlen; i++) {
        if (!PyDict_Check(v)) { has = 0; break; }
        v = PyDict_GetItem(v, PyTuple_GET_ITEM(rel, i));
        if (v == NULL) { has = 0; break; }
    }
    void *cell = buf_more(col);
    if (cell == NULL)
        return -1;
    switch (mode) {
    case M_STR: {
        long id = MISSING;
        if (has && PyUnicode_Check(v)) {
            id = intern_str(ids, strings, v);
            if (id == -2) return -1;
        }
        *(int32_t *)cell = (int32_t)id;
        break;
    }
    case M_VAL: {
        long id = MISSING;
        if (has) {
            int compound = 0;
            PyObject *key = encode_scalar(v, &compound);
            if (key == NULL && !compound && PyErr_Occurred())
                return -1;
            if (key == NULL && compound) {
                key = PyObject_CallFunctionObjArgs(encode_cb, v, NULL);
                if (key == NULL)
                    return -1;
                if (key == Py_None) {
                    Py_DECREF(key);
                    key = NULL;
                }
            }
            if (key != NULL) {
                id = intern_str(ids, strings, key);
                Py_DECREF(key);
                if (id == -2) return -1;
            }
        }
        *(int32_t *)cell = (int32_t)id;
        break;
    }
    case M_NUM: {
        double d = NAN;
        if (has && is_number(v)) {
            d = PyFloat_Check(v) ? PyFloat_AS_DOUBLE(v) : PyLong_AsDouble(v);
            if (d == -1.0 && PyErr_Occurred())
                PyErr_Clear(), d = NAN;
        }
        *(double *)cell = d;
        break;
    }
    case M_LEN: {
        double d = NAN;
        if (has && (PyList_Check(v) || PyDict_Check(v) || PyUnicode_Check(v))) {
            Py_ssize_t n = PyObject_Length(v);
            if (n < 0) return -1;
            d = (double)n;
        }
        *(double *)cell = d;
        break;
    }
    case M_PRESENT:
        *(uint8_t *)cell = (uint8_t)has;
        break;
    case M_TRUTHY:
        *(uint8_t *)cell = (uint8_t)(has && v != Py_False);
        break;
    default:
        PyErr_SetString(PyExc_ValueError, "bad mode");
        return -1;
    }
    return 0;
}

static PyObject *buf_take(Buf *b)
{
    /* hand the bytes to Python; frees the C buffer */
    PyObject *out = PyBytes_FromStringAndSize(b->p, b->len);
    PyMem_Free(b->p);
    b->p = NULL;
    return out;
}

/* base walk with "*" flattening; appends terminal list elements to out. */
static int collect_elems(PyObject *obj, PyObject *base, PyObject *star,
                         PyObject *out)
{
    Py_ssize_t blen = PyTuple_GET_SIZE(base);
    /* star-free fast path (the overwhelmingly common base shape,
     * e.g. spec.containers): one dict walk, no intermediate lists */
    int has_star = 0;
    for (Py_ssize_t i = 0; i < blen; i++) {
        int eq = PyObject_RichCompareBool(PyTuple_GET_ITEM(base, i), star,
                                          Py_EQ);
        if (eq < 0)
            return -1;
        if (eq) { has_star = 1; break; }
    }
    if (!has_star) {
        PyObject *v = walk_path(obj, base, 0);
        if (v == NULL || !PyList_Check(v))
            return 0;
        for (Py_ssize_t e = 0; e < PyList_GET_SIZE(v); e++)
            if (PyList_Append(out, PyList_GET_ITEM(v, e)) < 0)
                return -1;
        return 0;
    }
    PyObject *cur = PyList_New(0);
    if (cur == NULL || PyList_Append(cur, obj) < 0) {
        Py_XDECREF(cur);
        return -1;
    }
    for (Py_ssize_t i = 0; i < blen; i++) {
        PyObject *seg = PyTuple_GET_ITEM(base, i);
        PyObject *nxt = PyList_New(0);
        if (nxt == NULL) { Py_DECREF(cur); return -1; }
        int is_star = PyObject_RichCompareBool(seg, star, Py_EQ);
        if (is_star < 0) { Py_DECREF(cur); Py_DECREF(nxt); return -1; }
        for (Py_ssize_t j = 0; j < PyList_GET_SIZE(cur); j++) {
            PyObject *v = PyList_GET_ITEM(cur, j);
            if (is_star) {
                if (PyList_Check(v)) {
                    for (Py_ssize_t e = 0; e < PyList_GET_SIZE(v); e++)
                        if (PyList_Append(nxt, PyList_GET_ITEM(v, e)) < 0) {
                            Py_DECREF(cur); Py_DECREF(nxt); return -1;
                        }
                }
            } else if (PyDict_Check(v)) {
                PyObject *child = PyDict_GetItem(v, seg);
                if (child != NULL &&
                    PyList_Append(nxt, child) < 0) {
                    Py_DECREF(cur); Py_DECREF(nxt); return -1;
                }
            }
        }
        Py_DECREF(cur);
        cur = nxt;
    }
    for (Py_ssize_t j = 0; j < PyList_GET_SIZE(cur); j++) {
        PyObject *v = PyList_GET_ITEM(cur, j);
        if (PyList_Check(v)) {
            for (Py_ssize_t e = 0; e < PyList_GET_SIZE(v); e++)
                if (PyList_Append(out, PyList_GET_ITEM(v, e)) < 0) {
                    Py_DECREF(cur);
                    return -1;
                }
        }
    }
    Py_DECREF(cur);
    return 0;
}

/* elem_arrays(objs, base, rels, modes, ids, strings, encode_cb)
 *   -> (counts bytes [int32], [col bytes per rel]) */
static PyObject *py_elem_arrays(PyObject *self, PyObject *args)
{
    PyObject *objs, *base, *rels, *modes, *ids, *strings, *encode_cb;
    if (!PyArg_ParseTuple(args, "OOOOOOO", &objs, &base, &rels, &modes,
                          &ids, &strings, &encode_cb))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(objs);
    Py_ssize_t nr = PyList_GET_SIZE(rels);
    Buf counts;
    Buf colbuf[64];
    long mode_codes[64];
    Py_ssize_t nbuf = 0;
    PyObject *star = NULL, *elems = NULL, *out = NULL;
    if (nr > 64) {
        PyErr_SetString(PyExc_ValueError, "too many element columns");
        return NULL;
    }
    if (buf_init(&counts, n, 4) < 0)
        return NULL;
    for (Py_ssize_t r = 0; r < nr; r++) {
        mode_codes[r] = PyLong_AsLong(PyList_GET_ITEM(modes, r));
        if (buf_init(&colbuf[r], n, item_for_mode((int)mode_codes[r])) < 0)
            goto fail;
        nbuf = r + 1;
    }
    star = PyUnicode_FromString("*");
    elems = PyList_New(0);
    if (star == NULL || elems == NULL)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *o = PyList_GET_ITEM(objs, i);
        if (PyList_SetSlice(elems, 0, PyList_GET_SIZE(elems), NULL) < 0)
            goto fail;
        if (o != Py_None && collect_elems(o, base, star, elems) < 0)
            goto fail;
        Py_ssize_t ne = PyList_GET_SIZE(elems);
        void *cnt = buf_more(&counts);
        if (cnt == NULL)
            goto fail;
        *(int32_t *)cnt = (int32_t)ne;
        for (Py_ssize_t e = 0; e < ne; e++) {
            PyObject *elem = PyList_GET_ITEM(elems, e);
            for (Py_ssize_t r = 0; r < nr; r++) {
                if (append_cell(&colbuf[r], elem,
                                PyList_GET_ITEM(rels, r),
                                (int)mode_codes[r], ids, strings,
                                encode_cb) < 0)
                    goto fail;
            }
        }
    }
    Py_DECREF(elems);
    Py_DECREF(star);
    elems = star = NULL;
    {
        PyObject *cols = PyList_New(0);
        PyObject *cb = buf_take(&counts);
        if (cols == NULL || cb == NULL) {
            Py_XDECREF(cols);
            Py_XDECREF(cb);
            counts.p = NULL;
            goto fail;
        }
        counts.p = NULL;
        int ok = 1;
        for (Py_ssize_t r = 0; r < nbuf; r++) {
            PyObject *b = buf_take(&colbuf[r]);
            colbuf[r].p = NULL;
            if (b == NULL || PyList_Append(cols, b) < 0) {
                Py_XDECREF(b);
                ok = 0;
                break;
            }
            Py_DECREF(b);
        }
        nbuf = 0;
        if (ok)
            out = PyTuple_Pack(2, cb, cols);
        Py_DECREF(cb);
        Py_DECREF(cols);
        return out;
    }
fail:
    Py_XDECREF(elems);
    Py_XDECREF(star);
    if (counts.p != NULL)
        PyMem_Free(counts.p);
    for (Py_ssize_t r = 0; r < nbuf; r++)
        if (colbuf[r].p != NULL)
            PyMem_Free(colbuf[r].p);
    return NULL;
}

/* scalar_col(objs, path, mode, ids, strings, encode_cb) -> bytes
 * one cell per obj (tombstone None rows handled per mode defaults). */
static PyObject *py_scalar_col(PyObject *self, PyObject *args)
{
    PyObject *objs, *path, *ids, *strings, *encode_cb;
    int mode;
    if (!PyArg_ParseTuple(args, "OOiOOO", &objs, &path, &mode, &ids,
                          &strings, &encode_cb))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(objs);
    Buf out;
    if (buf_init(&out, n, item_for_mode(mode)) < 0)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *o = PyList_GET_ITEM(objs, i);
        if (o == Py_None) {
            void *cell = buf_more(&out);
            if (cell == NULL)
                goto fail;
            if (mode == M_STR || mode == M_VAL)
                *(int32_t *)cell = (int32_t)MISSING;
            else if (mode == M_NUM || mode == M_LEN)
                *(double *)cell = NAN;
            else
                *(uint8_t *)cell = 0;
            continue;
        }
        if (append_cell(&out, o, path, mode, ids, strings, encode_cb) < 0)
            goto fail;
    }
    return buf_take(&out);
fail:
    PyMem_Free(out.p);
    return NULL;
}

/* memb_fill(objs, keys_path, local, ids, buf, n_rows, l_pad)
 * local: dict {global interned id -> local row}; buf: writable
 * contiguous bool buffer of shape [l_pad, R] (row-major). */
static PyObject *py_memb_fill(PyObject *self, PyObject *args)
{
    PyObject *objs, *keys_path, *local, *ids, *bufobj;
    Py_ssize_t n_rows, l_pad;
    if (!PyArg_ParseTuple(args, "OOOOOnn", &objs, &keys_path, &local, &ids,
                          &bufobj, &n_rows, &l_pad))
        return NULL;
    Py_buffer buf;
    if (PyObject_GetBuffer(bufobj, &buf, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (buf.len < n_rows * l_pad) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "membership buffer too small");
        return NULL;
    }
    char *data = (char *)buf.buf;
    Py_ssize_t R = buf.len / l_pad;   /* row stride (r_pad) */
    Py_ssize_t n = PyList_GET_SIZE(objs);
    for (Py_ssize_t row = 0; row < n && row < n_rows; row++) {
        PyObject *o = PyList_GET_ITEM(objs, row);
        if (o == Py_None)
            continue;
        PyObject *d = walk_path(o, keys_path, 0);
        if (d == NULL || !PyDict_Check(d))
            continue;
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(d, &pos, &k, &v)) {
            if (!PyUnicode_Check(k) || v == Py_False)
                continue;
            PyObject *gid = PyDict_GetItem(ids, k);      /* interner id */
            if (gid == NULL)
                continue;
            PyObject *li = PyDict_GetItem(local, gid);
            if (li == NULL)
                continue;
            long l = PyLong_AsLong(li);
            if (l >= 0 && l < l_pad)
                data[l * R + row] = 1;
        }
    }
    PyBuffer_Release(&buf);
    Py_RETURN_NONE;
}

/* process_meta(objs, quote_cache, fallback_idx_out_list)
 * -> (keys list, api list, kind list, name list, ns list)
 *
 * Batch extraction of the cache path pieces for the COMMON object
 * shape: dict with string apiVersion/kind, metadata dict with string
 * name and absent-or-string namespace, apiVersion present in
 * quote_cache.  Any other object's index is appended to
 * fallback_idx_out_list and its slots are filled with None — the
 * Python caller routes those through the exact scalar path
 * (process_data), so semantics (errors, UnhandledData) stay there. */
static PyObject *py_process_meta(PyObject *self, PyObject *args)
{
    PyObject *objs, *qcache, *fallback;
    if (!PyArg_ParseTuple(args, "OOO", &objs, &qcache, &fallback))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(objs);
    PyObject *keys = PyList_New(n);
    PyObject *apis = PyList_New(n);
    PyObject *kinds = PyList_New(n);
    PyObject *names = PyList_New(n);
    PyObject *nss = PyList_New(n);
    if (!keys || !apis || !kinds || !names || !nss)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *o = PyList_GET_ITEM(objs, i);
        PyObject *api = NULL, *kind = NULL, *meta = NULL, *name = NULL,
                 *ns = NULL, *escaped = NULL;
        int ok = PyDict_Check(o)
            && (api = PyDict_GetItemString(o, "apiVersion")) != NULL
            && PyUnicode_Check(api) && PyUnicode_GET_LENGTH(api) > 0
            && (kind = PyDict_GetItemString(o, "kind")) != NULL
            && PyUnicode_Check(kind) && PyUnicode_GET_LENGTH(kind) > 0
            && (meta = PyDict_GetItemString(o, "metadata")) != NULL
            && PyDict_Check(meta)
            && (name = PyDict_GetItemString(meta, "name")) != NULL
            && PyUnicode_Check(name)
            && (escaped = PyDict_GetItem(qcache, api)) != NULL;
        if (ok) {
            ns = PyDict_GetItemString(meta, "namespace");
            if (ns == Py_None)
                ns = NULL;
            if (ns != NULL && !PyUnicode_Check(ns))
                ok = 0;
        }
        if (!ok) {
            PyObject *idx = PyLong_FromSsize_t(i);
            if (idx == NULL || PyList_Append(fallback, idx) < 0) {
                Py_XDECREF(idx);
                goto fail;
            }
            Py_DECREF(idx);
            PyList_SET_ITEM(keys, i, Py_NewRef(Py_None));
            PyList_SET_ITEM(apis, i, Py_NewRef(Py_None));
            PyList_SET_ITEM(kinds, i, Py_NewRef(Py_None));
            PyList_SET_ITEM(names, i, Py_NewRef(Py_None));
            PyList_SET_ITEM(nss, i, Py_NewRef(Py_None));
            continue;
        }
        PyObject *key = ns != NULL
            ? PyUnicode_FromFormat("namespace/%U/%U/%U/%U",
                                   ns, escaped, kind, name)
            : PyUnicode_FromFormat("cluster/%U/%U/%U", escaped, kind, name);
        if (key == NULL)
            goto fail;
        PyList_SET_ITEM(keys, i, key);
        PyList_SET_ITEM(apis, i, Py_NewRef(api));
        PyList_SET_ITEM(kinds, i, Py_NewRef(kind));
        PyList_SET_ITEM(names, i, Py_NewRef(name));
        PyList_SET_ITEM(nss, i, Py_NewRef(ns != NULL ? ns : Py_None));
    }
    {
        PyObject *out = PyTuple_Pack(5, keys, apis, kinds, names, nss);
        Py_DECREF(keys); Py_DECREF(apis); Py_DECREF(kinds);
        Py_DECREF(names); Py_DECREF(nss);
        return out;
    }
fail:
    Py_XDECREF(keys); Py_XDECREF(apis); Py_XDECREF(kinds);
    Py_XDECREF(names); Py_XDECREF(nss);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"elem_arrays", py_elem_arrays, METH_VARARGS,
     "aligned element-column extraction with '*' flattening"},
    {"scalar_col", py_scalar_col, METH_VARARGS,
     "per-resource scalar column extraction"},
    {"memb_fill", py_memb_fill, METH_VARARGS,
     "membership matrix fill"},
    {"process_meta", py_process_meta, METH_VARARGS,
     "batch cache-path/meta extraction for common-shape objects"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_colext", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__colext(void)
{
    return PyModule_Create(&moduledef);
}
