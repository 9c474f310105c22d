// JSON-tree deepcopy + dumps — the control plane's hottest functions,
// in C.
//
// deepcopy: the embedded apiserver (machinery/store.py) copies every
// object on get/list to give callers apiserver-like isolation;
// profiling the JAX package's 100/300-notebook loadtests put the (already
// tree-specialised) Python copy at the top of the profile. API objects
// are JSON-shaped trees — dict/list/str/int/float/bool/None — so this
// extension walks them with direct C-API calls and no memo/
// bookkeeping. Exotic leaves (never produced by the store, but callers
// may stash them) fall back to copy.deepcopy for exact parity with the
// Python implementation in machinery/objects.py.
//
// dumps: the web/API tier serialized every response through Python's
// json.dumps, which walks the whole (frozen, zero-copy) tree in the
// interpreter — the last Python-speed hop on an otherwise C-speed read
// path. This entry point serializes a JSON-shaped tree (including the
// FrozenDict/FrozenList dict/list subclasses the informer cache hands
// out) straight to a bytes object with EXACT json.dumps parity: same
// default separators (", " / ": "), same ensure_ascii escapes
// (surrogate pairs for non-BMP), same float repr (float.__repr__,
// Infinity/-Infinity/NaN), same int repr (int.__repr__, so IntEnum-ish
// subclasses encode as numbers). Anything it can't prove it serializes
// identically (non-str dict keys, unknown leaf types) raises the
// module's ``Fallback`` exception and the Python wrapper re-serializes
// with json.dumps — parity by construction, including error messages.
//
// Built lazily by odh_kubeflow_tpu_torch.native (jsontree_deepcopy /
// jsontree_dumps) as a real extension module with the CPython C API.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdio>
#include <new>
#include <string>

static PyObject* g_copy_deepcopy = NULL;

static PyObject* tree_copy(PyObject* obj) {
  if (PyDict_CheckExact(obj)) {
    PyObject* out = PyDict_New();
    if (!out) return NULL;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      PyObject* cv = tree_copy(value);
      if (!cv) {
        Py_DECREF(out);
        return NULL;
      }
      if (PyDict_SetItem(out, key, cv) < 0) {
        Py_DECREF(cv);
        Py_DECREF(out);
        return NULL;
      }
      Py_DECREF(cv);
    }
    return out;
  }
  if (PyList_CheckExact(obj)) {
    Py_ssize_t n = PyList_GET_SIZE(obj);
    PyObject* out = PyList_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* cv = tree_copy(PyList_GET_ITEM(obj, i));
      if (!cv) {
        Py_DECREF(out);
        return NULL;
      }
      PyList_SET_ITEM(out, i, cv);  // steals cv
    }
    return out;
  }
  if (PyUnicode_CheckExact(obj) || PyLong_CheckExact(obj) ||
      PyFloat_CheckExact(obj) || PyBool_Check(obj) || obj == Py_None) {
    Py_INCREF(obj);
    return obj;
  }
  // dict/list SUBCLASSES (the frozen read-only wrappers the informer
  // cache hands out, machinery/objects.py FrozenDict/FrozenList) copy
  // into PLAIN dicts/lists: this is the fast path behind mutable(),
  // the cache's copy-on-write escape hatch. PyDict_Next / the list
  // item API read the concrete storage directly, so no (blocked)
  // subclass method is ever invoked.
  if (PyDict_Check(obj)) {
    PyObject* out = PyDict_New();
    if (!out) return NULL;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      PyObject* cv = tree_copy(value);
      if (!cv) {
        Py_DECREF(out);
        return NULL;
      }
      if (PyDict_SetItem(out, key, cv) < 0) {
        Py_DECREF(cv);
        Py_DECREF(out);
        return NULL;
      }
      Py_DECREF(cv);
    }
    return out;
  }
  if (PyList_Check(obj)) {
    Py_ssize_t n = PyList_GET_SIZE(obj);
    PyObject* out = PyList_New(n);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* cv = tree_copy(PyList_GET_ITEM(obj, i));
      if (!cv) {
        Py_DECREF(out);
        return NULL;
      }
      PyList_SET_ITEM(out, i, cv);  // steals cv
    }
    return out;
  }
  return PyObject_CallFunctionObjArgs(g_copy_deepcopy, obj, NULL);
}

static PyObject* jsontree_deepcopy(PyObject* Py_UNUSED(self), PyObject* obj) {
  return tree_copy(obj);
}

// ---------------------------------------------------------------------------
// dumps — serialize a JSON-shaped tree to bytes, byte-identical to
// json.dumps(obj).encode() with default arguments.

static PyObject* g_fallback_exc = NULL;

static void append_escaped_string(std::string& out, PyObject* s) {
  // py_encode_basestring_ascii parity: printable ASCII minus '"'/'\\'
  // passes through; the short escapes for \b \t \n \f \r; everything
  // else (controls, DEL, non-ASCII) as lowercase \uXXXX, with
  // surrogate pairs above the BMP. Lone surrogates emit as-is, same as
  // the stdlib encoder.
  const int kind = PyUnicode_KIND(s);
  const void* data = PyUnicode_DATA(s);
  const Py_ssize_t n = PyUnicode_GET_LENGTH(s);
  char buf[16];
  out += '"';
  if (kind == PyUnicode_1BYTE_KIND) {
    // the overwhelmingly common case (ASCII names/labels): bulk-copy
    // maximal clean runs instead of appending char-by-char
    const unsigned char* p = (const unsigned char*)data;
    Py_ssize_t i = 0;
    while (i < n) {
      Py_ssize_t j = i;
      while (j < n && p[j] >= 0x20 && p[j] < 0x7f && p[j] != '"' &&
             p[j] != '\\')
        ++j;
      if (j > i) out.append((const char*)p + i, (size_t)(j - i));
      if (j >= n) break;
      unsigned char c = p[j];
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\b': out += "\\b"; break;
        case '\f': out += "\\f"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        default:
          std::snprintf(buf, sizeof(buf), "\\u%04x", (unsigned)c);
          out += buf;
      }
      i = j + 1;
    }
    out += '"';
    return;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    Py_UCS4 c = PyUnicode_READ(kind, data, i);
    if (c >= 0x20 && c < 0x7f && c != '"' && c != '\\') {
      out += static_cast<char>(c);
      continue;
    }
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c > 0xffff) {
          c -= 0x10000;
          std::snprintf(buf, sizeof(buf), "\\u%04x\\u%04x",
                        0xd800 + (unsigned)(c >> 10),
                        0xdc00 + (unsigned)(c & 0x3ff));
        } else {
          std::snprintf(buf, sizeof(buf), "\\u%04x", (unsigned)c);
        }
        out += buf;
    }
  }
  out += '"';
}

static int append_repr_of(std::string& out, PyObject* num, reprfunc repr) {
  // int/float repr through the BASE type's tp_repr, exactly what the
  // stdlib C encoder does — a subclass overriding __repr__ still
  // encodes as a plain number
  PyObject* r = repr(num);
  if (r == NULL) return -1;
  Py_ssize_t len = 0;
  const char* utf8 = PyUnicode_AsUTF8AndSize(r, &len);
  if (utf8 == NULL) {
    Py_DECREF(r);
    return -1;
  }
  out.append(utf8, (size_t)len);
  Py_DECREF(r);
  return 0;
}

static int tree_dump(PyObject* obj, std::string& out) {
  // bool before int (bool subclasses int), exact checks before the
  // subclass checks so plain API objects never branch-miss
  if (obj == Py_True) {
    out += "true";
    return 0;
  }
  if (obj == Py_False) {
    out += "false";
    return 0;
  }
  if (obj == Py_None) {
    out += "null";
    return 0;
  }
  if (PyUnicode_Check(obj)) {
    append_escaped_string(out, obj);
    return 0;
  }
  if (PyLong_Check(obj)) {
    return append_repr_of(out, obj, PyLong_Type.tp_repr);
  }
  if (PyFloat_Check(obj)) {
    double v = PyFloat_AS_DOUBLE(obj);
    if (std::isnan(v)) {
      out += "NaN";
    } else if (std::isinf(v)) {
      out += (v > 0) ? "Infinity" : "-Infinity";
    } else {
      return append_repr_of(out, obj, PyFloat_Type.tp_repr);
    }
    return 0;
  }
  if (PyDict_Check(obj)) {  // FrozenDict included: PyDict_Next reads
    if (Py_EnterRecursiveCall(" while serializing JSON tree")) return -1;
    out += '{';            // the concrete storage, no methods invoked
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    bool first = true;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      if (!PyUnicode_Check(key)) {
        // json.dumps coerces int/float/bool/None keys (and raises on
        // the rest); both are rare enough to hand the WHOLE call back
        Py_LeaveRecursiveCall();
        PyErr_SetString(g_fallback_exc, "non-str dict key");
        return -1;
      }
      if (!first) out += ", ";
      first = false;
      append_escaped_string(out, key);
      out += ": ";
      if (tree_dump(value, out) < 0) {
        Py_LeaveRecursiveCall();
        return -1;
      }
    }
    out += '}';
    Py_LeaveRecursiveCall();
    return 0;
  }
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    if (Py_EnterRecursiveCall(" while serializing JSON tree")) return -1;
    const bool is_list = PyList_Check(obj);
    const Py_ssize_t n =
        is_list ? PyList_GET_SIZE(obj) : PyTuple_GET_SIZE(obj);
    out += '[';
    for (Py_ssize_t i = 0; i < n; ++i) {
      if (i) out += ", ";
      PyObject* item =
          is_list ? PyList_GET_ITEM(obj, i) : PyTuple_GET_ITEM(obj, i);
      if (tree_dump(item, out) < 0) {
        Py_LeaveRecursiveCall();
        return -1;
      }
    }
    out += ']';
    Py_LeaveRecursiveCall();
    return 0;
  }
  PyErr_SetString(g_fallback_exc, "leaf type the C serializer cannot prove");
  return -1;
}

static PyObject* jsontree_dumps(PyObject* Py_UNUSED(self), PyObject* obj) {
  try {
    std::string out;
    out.reserve(512);
    if (tree_dump(obj, out) < 0) return NULL;
    return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
  } catch (const std::bad_alloc&) {
    PyErr_NoMemory();
    return NULL;
  }
}

static PyMethodDef Methods[] = {
    {"deepcopy", (PyCFunction)jsontree_deepcopy, METH_O,
     "Deep copy a JSON-shaped tree (dict/list/scalars); exotic leaves "
     "fall back to copy.deepcopy."},
    {"dumps", (PyCFunction)jsontree_dumps, METH_O,
     "Serialize a JSON-shaped tree to bytes, byte-identical to "
     "json.dumps(obj).encode(); raises Fallback for input it cannot "
     "prove identical (the wrapper re-serializes via json.dumps)."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "_odhkf_torch_jsontree",
                                       NULL,
                                       -1,
                                       Methods,
                                       NULL,
                                       NULL,
                                       NULL,
                                       NULL};

PyMODINIT_FUNC PyInit__odhkf_torch_jsontree(void) {
  PyObject* copy_mod = PyImport_ImportModule("copy");
  if (!copy_mod) return NULL;
  g_copy_deepcopy = PyObject_GetAttrString(copy_mod, "deepcopy");
  Py_DECREF(copy_mod);
  if (!g_copy_deepcopy) return NULL;
  PyObject* mod = PyModule_Create(&moduledef);
  if (!mod) return NULL;
  g_fallback_exc =
      PyErr_NewException("_odhkf_torch_jsontree.Fallback", NULL, NULL);
  if (!g_fallback_exc || PyModule_AddObject(mod, "Fallback", g_fallback_exc) < 0) {
    Py_XDECREF(g_fallback_exc);
    Py_DECREF(mod);
    return NULL;
  }
  Py_INCREF(g_fallback_exc);  // module owns one ref; keep ours for C use
  return mod;
}
