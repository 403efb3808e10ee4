// pwicp_capi — drop-in C ABI matching the reference DLL surface.
//
// The reference ships python/PCL_DLL/PwICP_x64R.dll exposing two C symbols
// (include/Registration.h:36,49) consumed via ctypes (python/main.py:15-18):
//
//     bool PiecewiseICP_pair_call(const char* confile, const char* outfile);
//     bool PiecewiseICP_4D_call(const char* confile, int startEpoch,
//                               int epochNum, int pairMode, float overlapThd);
//
// This library exposes the SAME symbols, delegating to the JAX framework
// through an embedded (or already-running) CPython interpreter, so any
// existing C/C++/ctypes caller of the reference DLL can switch by swapping
// the library path.
//
// Build: g++ -O2 -shared -fPIC pwicp_capi.cpp \
//            $(python3-config --includes) $(python3-config --ldflags --embed) \
//            -o libpwicp_capi.so

#include <Python.h>

namespace {

bool ensure_python() {
    if (!Py_IsInitialized()) {
        Py_Initialize();
    }
    return Py_IsInitialized();
}

bool call_entry(const char* func, PyObject* args) {
    if (!ensure_python()) return false;
    PyGILState_STATE gil = PyGILState_Ensure();
    bool ok = false;
    PyObject* mod = PyImport_ImportModule("piecewise_icp");
    if (mod) {
        PyObject* fn = PyObject_GetAttrString(mod, func);
        if (fn) {
            PyObject* res = PyObject_CallObject(fn, args);
            if (res) {
                ok = PyObject_IsTrue(res) == 1;
                Py_DECREF(res);
            } else {
                PyErr_Print();
            }
            Py_DECREF(fn);
        }
        Py_DECREF(mod);
    } else {
        PyErr_Print();
    }
    Py_XDECREF(args);
    PyGILState_Release(gil);
    return ok;
}

}  // namespace

extern "C" {

bool PiecewiseICP_pair_call(const char* confile, const char* outfile) {
    PyGILState_STATE gil;
    if (!ensure_python()) return false;
    gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue("(ss)", confile, outfile);
    PyGILState_Release(gil);
    return call_entry("piecewise_icp_pair_call", args);
}

bool PiecewiseICP_4D_call(const char* confile, int startEpoch, int epochNum,
                          int pairMode, float overlapThd) {
    PyGILState_STATE gil;
    if (!ensure_python()) return false;
    gil = PyGILState_Ensure();
    PyObject* args = Py_BuildValue("(siiif)", confile, startEpoch, epochNum,
                                   pairMode, (double)overlapThd);
    PyGILState_Release(gil);
    return call_entry("piecewise_icp_4d_call", args);
}

}  // extern "C"
