"""Capture contract rules (MDT1xx): the port's counterpart of the JAX
package's jit/jaxpr contracts.

PyTorch runs eagerly; what the JAX package traces, the port captures:
a cached scan group runs eagerly at its first hit and as a CUDA graph
from its second (``parallel/executors._run_group``).  A captured body
runs its Python once, at capture, and the graph replays the kernels it
queued.  The rule ids stay the JAX package's (baselines and pragmas key
on them); what each checks is said here.

- **AST tier** (stdlib-only, always runs): :func:`check_module` finds
  the functions that run inside a capture, then walks the same-module
  call graph from them.  The roots are the functions an analysis'
  ``_batch_fn`` returns (through same-module factories), the functions
  bound to ``_device_fold_fn`` and ``_device_combine``, the functions
  handed to ``vmap`` (``torch.vmap``/``torch.func.vmap``), and the
  bodies handed to ``_run_group``/``_GroupGraph``.  A class that
  declares ``_host_waits_in_batch = True`` is never captured: its batch
  functions' host waits are declared, not flagged.

  - **MDT101 host-side-effect-in-captured** — ``time.*``,
    ``random.*``, ``np.*``/``numpy.*`` and ``print`` run once, at
    capture, and their value is baked into every replay; ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()`` and
    ``torch.cuda.synchronize()`` wait on the device from the host,
    which a capture cannot hold: the group's capture raises at its
    second hit, and nothing falls back.
  - **MDT102 global-state-in-captured** — ``global``/``nonlocal``
    inside captured code mutates at capture only; replays skip it.

- **Capture tier** (``--graphs``, imports torch):
  :func:`check_captured_programs` runs the registered programs three
  times each over one :class:`~mdanalysis_mpi_tpu_torch.parallel.
  executors.DeviceBlockCache` (populate, first hit, capture) and
  checks, while the scanned passes run and on the graphs they leave:

  - **MDT110 one-combine-per-scan-group** — no
    :class:`~mdanalysis_mpi_tpu_torch.parallel.distributed.Collectives`
    method and no ``torch.distributed`` collective inside a group body,
    and the analysis' ``_device_combine`` called once a group, not once
    a block (the JAX package's one psum per scan).  A single-device
    program may call no collective at all.
  - **MDT111 captured-host-constants** — the bytes a captured graph
    holds from the host (its host-to-device copy nodes) stay within
    :data:`CONST_BUDGET_BYTES`: such a copy replays the same host bytes
    every time, a baked constant.  The
    graph's hand-kernel nodes must equal the launches the capture
    recorded (``_GroupGraph.launches``).

  On the CPU (``device="cpu"``) the bodies run eagerly and MDT110 alone
  is checked: MDT111 needs a captured graph.
"""

from __future__ import annotations

import ast

from mdanalysis_mpi_tpu_torch.lint.core import Finding, Rule, register

register(Rule(
    "MDT101", "host-side-effect-in-captured", "capture",
    "time/random/np/print or a host sync (.item/.cpu/.tolist/.numpy/"
    "torch.cuda.synchronize) inside a function a CUDA graph captures",
    "a captured body runs its Python once: host values are baked into "
    "every replay, and a host wait makes the group's capture raise at "
    "its second cache hit, with nothing to fall back to"))
register(Rule(
    "MDT102", "global-state-in-captured", "capture",
    "global/nonlocal mutation inside a captured function",
    "mutation happens at capture only - graph replays silently skip "
    "it"))
register(Rule(
    "MDT110", "one-combine-per-scan-group", "graph",
    "collective inside a cached group's body, or _device_combine "
    "called more than once a scan group",
    "the scan fold merges LOCAL partials once a group (the JAX "
    "package's one psum per scan); a merge per block multiplies the "
    "cross-device traffic by the group length", True))
register(Rule(
    "MDT111", "captured-host-constants", "graph",
    "captured group graph holds host bytes over the budget, or its "
    "hand-kernel nodes differ from the launches it recorded",
    "a host-to-device copy inside a capture replays the same host "
    "bytes every time - a baked constant that re-ships with every "
    "replay - and a kernel count that disagrees with the graph means "
    "the launch counters lie", True))

#: Name roots whose attribute-calls are host-side inside a capture
#: (``np`` is numpy's customary alias).
_HOST_ROOTS = {"time", "random", "np", "numpy"}

#: Tensor methods that wait on the device from the host (no-argument
#: calls): a capture cannot hold them.
_HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}

#: Transforms whose first argument is the function they batch.
_VMAP_NAMES = {"vmap"}

#: Calls whose argument is a cached group's body: ``name → (positional
#: index, keyword)``.
_BODY_CALLS = {"_run_group": (4, "body"), "_GroupGraph": (0, "body")}

#: Analysis class attributes bound to functions that run on the device.
_BOUND_ROOTS = ("_device_fold_fn", "_device_combine")

#: Per-graph budget of host bytes for MDT111.  Small launch constants
#: are fine; a coordinate block is not.
CONST_BUDGET_BYTES = 1 << 20

#: The hand kernels of ``csrc/``: the wrapper that counts a launch →
#: its CUDA kernel's name (a substring of the mangled symbol).
HAND_KERNELS = {"planar_sums": "fused_planar_kernel",
                "pair_histogram": "pair_hist_kernel"}


# ---------------------------------------------------------------- AST tier

def _unwrap_arg(node: ast.AST) -> ast.AST:
    """Peel single-positional-argument wrapper calls:
    ``staticmethod(f)`` → ``f``."""
    while isinstance(node, ast.Call) and node.args:
        node = node.args[0]
    return node


class _Scope:
    """One lexical function-def scope: local defs by name + parent."""

    def __init__(self, parent=None):
        self.parent = parent
        self.defs: dict[str, ast.AST] = {}

    def resolve(self, name: str):
        scope = self
        while scope is not None:
            if name in scope.defs:
                return scope.defs[name]
            scope = scope.parent
        return None


def _index_scopes(tree: ast.Module):
    """Map every FunctionDef node to the :class:`_Scope` it opens, so
    ``Name`` references resolve lexically.  Class bodies open no scope
    (methods do not see each other by bare name)."""
    node_scope: dict[ast.AST, _Scope] = {}

    def walk(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope.defs[child.name] = child
                inner = _Scope(scope)
                node_scope[child] = inner
                walk(child, inner)
            elif isinstance(child, ast.ClassDef):
                walk(child, _Scope(scope))
            else:
                walk(child, scope)

    top = _Scope()
    walk(tree, top)
    return node_scope, top


def _qualname(node: ast.AST, parents: dict) -> str:
    parts = []
    cur = node
    while cur is not None:
        name = getattr(cur, "name", None)
        if name and isinstance(cur, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
            parts.append(name)
        cur = parents.get(cur)
    return ".".join(reversed(parts)) or "<module>"


def _own_returns(fndef: ast.AST):
    """The ``return`` values of ``fndef`` itself (not of nested defs)."""
    out = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.Return) and child.value is not None:
                out.append(child.value)
            walk(child)

    walk(fndef)
    return out


def _host_waits_declared(cls: ast.ClassDef) -> bool:
    """``_host_waits_in_batch = True`` in the class body."""
    for node in cls.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name)
                        and t.id == "_host_waits_in_batch"
                        for t in node.targets)
                and isinstance(node.value, ast.Constant)
                and node.value.value is True):
            return True
    return False


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name → imported module for ``import x as y`` anywhere in
    the file (``import time as _time`` → ``{"_time": "time"}``)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
    return out


def _dotted(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize`` for that attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def captured_roots(tree: ast.Module, parents: dict, node_scope: dict,
                   top) -> list:
    """The functions of this module that run inside a capture (the
    AST tier's roots; see the module docstring)."""
    roots: list[ast.AST] = []

    def scope_at(node):
        encl = node
        while encl is not None and encl not in node_scope:
            encl = parents.get(encl)
        return node_scope.get(encl, top)

    def add(expr, scope, depth=0):
        """The function(s) ``expr`` evaluates to, through same-module
        factories (``return _rdf_kernel(...)`` → what it returns)."""
        if isinstance(expr, ast.Lambda):
            roots.append(expr)
        elif isinstance(expr, ast.Name):
            fn = scope.resolve(expr.id)
            if fn is not None:
                roots.append(fn)
        elif isinstance(expr, ast.IfExp):
            add(expr.body, scope, depth)
            add(expr.orelse, scope, depth)
        elif (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
              and depth < 4):
            factory = scope.resolve(expr.func.id)
            if factory is not None:
                inner = node_scope[factory]
                for ret in _own_returns(factory):
                    add(ret, inner, depth + 1)

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            declared = _host_waits_declared(node)
            for item in node.body:
                if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name == "_batch_fn" and not declared):
                    for ret in _own_returns(item):
                        add(ret, node_scope[item])
                elif isinstance(item, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id in _BOUND_ROOTS
                        for t in item.targets):
                    add(_unwrap_arg(item.value), scope_at(node))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute) else None)
            target = None
            if name in _VMAP_NAMES and node.args:
                target = _unwrap_arg(node.args[0])
            elif name in _BODY_CALLS:
                pos, kw = _BODY_CALLS[name]
                if len(node.args) > pos:
                    target = node.args[pos]
                for k in node.keywords:
                    if k.arg == kw:
                        target = k.value
            if target is not None:
                add(target, scope_at(node))
    return roots


def _may_capture(tree: ast.Module) -> bool:
    """Does the file hold any candidate root at all (a ``_batch_fn``
    method, a bound fold/combine, a vmap or a group-body call)?  Most
    files do not, and skip the scope and call-graph work."""
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_batch_fn":
            return True
        if isinstance(node, ast.Name) and (
                node.id in _BOUND_ROOTS or node.id in _VMAP_NAMES
                or node.id in _BODY_CALLS):
            return True
        if isinstance(node, ast.Attribute) and (
                node.attr in _VMAP_NAMES or node.attr in _BODY_CALLS):
            return True
    return False


def check_module(tree: ast.Module, rel: str) -> list[Finding]:
    findings: list[Finding] = []
    if not _may_capture(tree):
        return findings
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    node_scope, top = _index_scopes(tree)
    roots = captured_roots(tree, parents, node_scope, top)
    aliases = _import_aliases(tree)

    # transitive closure over same-module calls
    captured: list = []
    seen: set[int] = set()
    stack = list(roots)
    while stack:
        fndef = stack.pop()
        if id(fndef) in seen:
            continue
        seen.add(id(fndef))
        captured.append(fndef)
        scope = node_scope.get(fndef, top)
        for node in ast.walk(fndef):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                callee = scope.resolve(node.func.id)
                if callee is not None:
                    stack.append(callee)

    for fndef in captured:
        sym = _qualname(fndef, parents)
        for node in ast.walk(fndef):
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Name) and fn.id == "print":
                    findings.append(Finding(
                        "MDT101", rel, node.lineno, sym,
                        "print() inside a captured function runs at "
                        "capture only", detail="print"))
                elif isinstance(fn, ast.Attribute):
                    root = fn.value
                    while isinstance(root, ast.Attribute):
                        root = root.value
                    module = (aliases.get(root.id, root.id)
                              if isinstance(root, ast.Name) else None)
                    if module in _HOST_ROOTS:
                        findings.append(Finding(
                            "MDT101", rel, node.lineno, sym,
                            f"host call `{root.id}.{fn.attr}` inside a "
                            f"captured function (its value is baked "
                            f"into every replay)",
                            detail=f"{root.id}.{fn.attr}"))
                    elif _dotted(fn) == "torch.cuda.synchronize":
                        findings.append(Finding(
                            "MDT101", rel, node.lineno, sym,
                            "torch.cuda.synchronize() inside a captured "
                            "function: a capture cannot hold a host "
                            "wait", detail="torch.cuda.synchronize"))
                    elif (fn.attr in _HOST_SYNC_METHODS and not node.args
                          and not node.keywords):
                        findings.append(Finding(
                            "MDT101", rel, node.lineno, sym,
                            f".{fn.attr}() inside a captured function "
                            f"waits on the device from the host (the "
                            f"group's capture raises; declare "
                            f"`_host_waits_in_batch = True` if the wait "
                            f"is meant)", detail=f".{fn.attr}"))
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                word = ("global" if isinstance(node, ast.Global)
                        else "nonlocal")
                findings.append(Finding(
                    "MDT102", rel, node.lineno, sym,
                    f"`{word} {', '.join(node.names)}` inside a captured "
                    f"function "
                    f"mutates at capture only",
                    detail=",".join(node.names)))
    return findings


# ------------------------------------------------------------ capture tier
#
# A graph node is a plain ``(kind, nbytes, name)`` tuple: ``kind`` one of
# "kernel", "memcpy_htod", "memcpy_dtoh", "memcpy_dtod", "memset",
# "host", "graph", "empty", "event", "mem_alloc", "mem_free", "other";
# ``nbytes`` the bytes the node holds from the host (a host-to-device
# copy's size; 0 otherwise); ``name`` the kernel's
# symbol, or what the node moves.  The predicates below take such lists,
# so they are tested on the CPU.

def host_constant_bytes(nodes) -> int:
    """Bytes a graph replays from the host (the MDT111 measure)."""
    return sum(n for kind, n, _ in nodes if kind == "memcpy_htod")


def hand_kernel_nodes(nodes) -> dict[str, int]:
    """Kernel nodes of each hand kernel (by wrapper name)."""
    out = {w: 0 for w in HAND_KERNELS}
    for kind, _, name in nodes:
        if kind != "kernel":
            continue
        for wrapper, symbol in HAND_KERNELS.items():
            if symbol in name:
                out[wrapper] += 1
    return out


def graph_findings(program: str, index: int, nodes,
                   launches: dict[str, int]) -> list[Finding]:
    """MDT111 over one captured graph's ``nodes``, given the hand-kernel
    launches its capture recorded (wrapper name → count)."""
    rel = "mdanalysis_mpi_tpu_torch/parallel/executors.py"
    out = []
    nbytes = host_constant_bytes(nodes)
    if nbytes > CONST_BUDGET_BYTES:
        out.append(Finding(
            "MDT111", rel, 0, program,
            f"graph {index} replays {nbytes} bytes from the host "
            f"(budget {CONST_BUDGET_BYTES}): data must reach a captured "
            f"body as a static input, not be copied in from the host "
            f"inside the capture", detail=f"graph{index}:host_bytes"))
    nodes_by = hand_kernel_nodes(nodes)
    want = {w: launches.get(w, 0) for w in HAND_KERNELS}
    if nodes_by != want:
        out.append(Finding(
            "MDT111", rel, 0, program,
            f"graph {index} holds hand-kernel nodes {nodes_by} but its "
            f"capture recorded launches {want}: the launch counters "
            f"disagree with what replays", detail=f"graph{index}:kernels"))
    return out


_CU_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
             5: "empty", 6: "event", 7: "event", 10: "mem_alloc",
             11: "mem_free"}
_CU_MEMORYTYPE_HOST = 1
_CU_MEMORYTYPE_UNIFIED = 4
_CU_POINTER_ATTRIBUTE_MEMORY_TYPE = 2


def _driver():
    """``libcuda`` through :mod:`ctypes`, with the graph-query entry
    points' argument types declared (the CUDA driver API: a
    ``cudaGraph_t`` is a ``CUgraph``)."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    for fn, args in (
            ("cuGraphGetNodes", [vp, vp, ctypes.POINTER(sz)]),
            ("cuGraphNodeGetType", [vp, ctypes.POINTER(ctypes.c_int)]),
            ("cuGraphMemcpyNodeGetParams", [vp, vp]),
            ("cuGraphKernelNodeGetParams_v2", [vp, vp]),
            ("cuGraphChildGraphNodeGetGraph", [vp, ctypes.POINTER(vp)]),
            ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), vp]),
            ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p), vp]),
            ("cuPointerGetAttribute", [vp, ctypes.c_int, ctypes.c_uint64])):
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = ctypes.c_int
    return lib


def _structs():
    import ctypes

    sz, vp, u64 = ctypes.c_size_t, ctypes.c_void_p, ctypes.c_uint64
    ui = ctypes.c_uint

    def side(p):
        return [(p + "XInBytes", sz), (p + "Y", sz), (p + "Z", sz),
                (p + "LOD", sz), (p + "MemoryType", ctypes.c_int),
                (p + "Host", vp), (p + "Device", u64), (p + "Array", vp),
                (p + "Reserved", vp), (p + "Pitch", sz),
                (p + "Height", sz)]

    class Memcpy3D(ctypes.Structure):          # CUDA_MEMCPY3D
        _fields_ = side("src") + side("dst") + [
            ("WidthInBytes", sz), ("Height", sz), ("Depth", sz)]

    class Kernel(ctypes.Structure):            # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", vp), ("gridDimX", ui), ("gridDimY", ui),
                    ("gridDimZ", ui), ("blockDimX", ui), ("blockDimY", ui),
                    ("blockDimZ", ui), ("sharedMemBytes", ui),
                    ("kernelParams", vp), ("extra", vp), ("kern", vp),
                    ("ctx", vp)]

    return Memcpy3D, Kernel


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def read_graph_nodes(raw_graph: int) -> list[tuple[str, int, str]]:
    """Every node of a ``cudaGraph_t`` (child graphs included) as
    ``(kind, nbytes, name)`` — read with the CUDA driver API."""
    import ctypes

    lib = _driver()
    Memcpy3D, Kernel = _structs()

    def mem_side(mtype, dev_ptr):
        if mtype == _CU_MEMORYTYPE_UNIFIED:
            t = ctypes.c_uint(0)
            rc = lib.cuPointerGetAttribute(
                ctypes.byref(t), _CU_POINTER_ATTRIBUTE_MEMORY_TYPE, dev_ptr)
            # pageable host memory is unknown to the CUDA driver
            return (t.value if rc == 0 else _CU_MEMORYTYPE_HOST)
        return mtype

    def kernel_name(node):
        p = Kernel()
        _ok(lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.func and lib.cuFuncGetName(ctypes.byref(name), p.func) == 0:
            return name.value.decode()
        if p.kern and lib.cuKernelGetName(ctypes.byref(name), p.kern) == 0:
            return name.value.decode()
        raise RuntimeError("a kernel node's function has no name the "
                           "driver can read (cuFuncGetName/cuKernelGetName)")

    def walk(graph, out):
        n = ctypes.c_size_t(0)
        _ok(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)),
            "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        _ok(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
            "cuGraphGetNodes")
        for node in nodes[:n.value]:
            t = ctypes.c_int(-1)
            _ok(lib.cuGraphNodeGetType(node, ctypes.byref(t)),
                "cuGraphNodeGetType")
            kind = _CU_KINDS.get(t.value, "other")
            if kind == "kernel":
                out.append(("kernel", 0, kernel_name(node)))
            elif kind == "memcpy":
                p = Memcpy3D()
                _ok(lib.cuGraphMemcpyNodeGetParams(node, ctypes.byref(p)),
                    "cuGraphMemcpyNodeGetParams")
                size = (p.WidthInBytes * max(p.Height, 1)
                        * max(p.Depth, 1))
                src = mem_side(p.srcMemoryType, p.srcDevice)
                dst = mem_side(p.dstMemoryType, p.dstDevice)
                if src == _CU_MEMORYTYPE_HOST:
                    out.append(("memcpy_htod", size, f"{size} B"))
                elif dst == _CU_MEMORYTYPE_HOST:
                    out.append(("memcpy_dtoh", 0, f"{size} B"))
                else:
                    out.append(("memcpy_dtod", 0, f"{size} B"))
            elif kind == "graph":
                child = ctypes.c_void_p()
                _ok(lib.cuGraphChildGraphNodeGetGraph(
                    node, ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                out.append(("graph", 0, "child"))
                walk(child, out)
            else:
                out.append((kind, 0, ""))
        return out

    return walk(ctypes.c_void_p(raw_graph), [])


def group_graph_nodes(prog) -> list[tuple[str, int, str]]:
    """The nodes of an ``executors._GroupGraph`` captured under a
    :class:`GroupProbe` (which keeps its ``cudaGraph_t``)."""
    return read_graph_nodes(prog.graph.raw_cuda_graph())


def _launch_names(launches) -> dict[str, int]:
    out: dict[str, int] = {}
    for wrapper in launches:
        out[wrapper.__name__] = out.get(wrapper.__name__, 0) + 1
    return out


#: marks an attribute that was not set on the instance
_NONE = object()

#: ``torch.distributed`` functions that move data between ranks
_DIST_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "reduce", "all_to_all", "all_to_all_single", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "barrier")
#: the port's collective wrappers (``parallel/distributed.py``)
_COLLECTIVE_METHODS = ("all_reduce", "all_reduce_tree", "all_gather_cat",
                       "all_gather_tree", "ring_shift")


class GroupProbe:
    """``with GroupProbe(analysis) as probe:`` — counts, while a pass
    runs, the cached-group bodies entered (``executors._run_group``),
    each collective called (``Collectives`` methods and
    ``torch.distributed`` functions) inside a body and anywhere, and
    the calls of ``analysis._device_combine``; keeps a copy of every
    group dispatch's output in ``outputs[(key, tag)]``, in order (pass
    one dict to several probes to follow a group across runs).  Every
    group graph captured inside the block keeps its ``cudaGraph_t``
    (``_GroupGraph.keep_graph``), for :func:`group_graph_nodes`.
    Patches module and class attributes for its ``with`` block only."""

    def __init__(self, analysis=None, outputs: dict | None = None):
        import threading

        self.analysis = analysis
        self.bodies = 0
        self.combines = 0
        self.collectives: dict[str, int] = {}
        self.in_body: dict[str, int] = {}
        self.outputs = {} if outputs is None else outputs
        self._local = threading.local()
        self._undo: list = []
        self._own_combine = None

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def _count(self, label):
        def make(orig):
            def counted(*args, **kwargs):
                self.collectives[label] = self.collectives.get(label, 0) + 1
                if getattr(self._local, "depth", 0):
                    self.in_body[label] = self.in_body.get(label, 0) + 1
                return orig(*args, **kwargs)
            return counted
        return make

    def __enter__(self):
        import torch.distributed as dist

        from mdanalysis_mpi_tpu_torch.parallel import executors
        from mdanalysis_mpi_tpu_torch.parallel.distributed import (
            Collectives)

        for name in _COLLECTIVE_METHODS:
            self._patch(Collectives, name,
                        self._count(f"Collectives.{name}"))
        for name in _DIST_COLLECTIVES:
            if hasattr(dist, name):
                self._patch(dist, name,
                            self._count(f"torch.distributed.{name}"))

        def run_group(orig):
            def probed(cache, key, entry, tag, body, *rest, **kw):
                def counted_body(p, tot):
                    self._local.depth = getattr(self._local, "depth", 0) + 1
                    try:
                        return body(p, tot)
                    finally:
                        self._local.depth -= 1

                self.bodies += 1
                out = orig(cache, key, entry, tag, counted_body, *rest,
                           **kw)
                self.outputs.setdefault((key, tag), []).append(
                    executors._clone_tree(out))
                return out
            return probed

        self._patch(executors, "_run_group", run_group)
        self._patch(executors._GroupGraph, "keep_graph", lambda _: True)
        a = self.analysis
        if a is not None and a._device_combine is not None:
            combine = a._device_combine

            def counted_combine(parts, comm=None):
                self.combines += 1
                return combine(parts, comm)

            # an instance attribute shadows the class's staticmethod
            self._own_combine = vars(a).get("_device_combine", _NONE)
            a._device_combine = counted_combine
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()
        if self._own_combine is not None:
            if self._own_combine is _NONE:
                del self.analysis._device_combine
            else:
                self.analysis._device_combine = self._own_combine
            self._own_combine = None
        return False


def combine_findings(program: str, probe: GroupProbe, shards: int,
                     single_device: bool) -> list[Finding]:
    """MDT110 over one scanned pass, as ``probe`` saw it: ``shards``
    bodies make one group dispatch (a mesh's devices)."""
    rel = "mdanalysis_mpi_tpu_torch/parallel/executors.py"
    out = []
    for label, n in sorted(probe.in_body.items()):
        out.append(Finding(
            "MDT110", rel, 0, program,
            f"{n} call(s) of {label} inside a cached group's body: the "
            f"scan contract is local accumulation with one merge a "
            f"group, outside the body", detail=f"body:{label}"))
    if single_device:
        outside = {k: n - probe.in_body.get(k, 0)
                   for k, n in probe.collectives.items()}
        for label, n in sorted(outside.items()):
            if n:
                out.append(Finding(
                    "MDT110", rel, 0, program,
                    f"{n} call(s) of {label} in a single-device program "
                    f"(expected none)", detail=f"single:{label}"))
        return out
    groups = probe.bodies // max(shards, 1)
    if probe.combines != groups:
        out.append(Finding(
            "MDT110", rel, 0, program,
            f"_device_combine ran {probe.combines} times over {groups} "
            f"scan groups (expected one a group): the merge multiplied "
            f"with the blocks", detail="combines"))
    return out


def _tree_equal(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b.to(a.device)))
    return a == b


def _wrapper_counts() -> dict[str, int]:
    from mdanalysis_mpi_tpu_torch.ops import fused_distances, fused_planar

    return {"planar_sums": fused_planar.planar_sums.launches,
            "pair_histogram": fused_distances.pair_histogram.launches}


def check_program(name: str, make_analysis, executor, *, shards: int = 1,
                  single_device: bool = True):
    """Run ``make_analysis().run(backend=executor)`` three times over
    ``executor.block_cache`` (a fresh ``DeviceBlockCache``):
    the first run stages and fills the cache, and each cached group
    (one a program tag) runs eagerly at its first hit and, on a CUDA
    device, is captured at its second and replayed from then on.
    MDT110 is checked over the second and third runs (every group a
    cache hit), MDT111 on every graph the cache keeps (CUDA only).
    → ``(findings, report)``; the report holds each run's groups,
    combines and collectives, each graph's nodes, whether every later
    output of a group equals its first (eager) one bit for bit, and the
    hand kernels' launches over the three runs."""
    import torch

    cache = executor.block_cache
    if cache is None:
        raise ValueError("check_program needs an executor with a "
                         "block_cache (a DeviceBlockCache)")
    on_card = torch.device(executor.device).type == "cuda"
    findings: list[Finding] = []
    report = {"name": name, "device": str(executor.device),
              "passes": []}
    k0 = _wrapper_counts()
    outputs: dict = {}
    for leg in ("fill", "hit 1", "hit 2"):
        a = make_analysis()
        with GroupProbe(a, outputs) as probe:
            a.run(backend=executor)
        if on_card:
            torch.cuda.synchronize()
        if leg == "fill":
            continue
        if probe.bodies == 0:
            raise RuntimeError(
                f"{name}: the {leg} run dispatched no cached group, so it "
                f"is no scan program (a cache too small, or a scan_k of 1)")
        findings += combine_findings(name, probe, shards, single_device)
        report["passes"].append({
            "run": leg, "bodies": probe.bodies,
            "groups": probe.bodies // shards, "combines": probe.combines,
            "collectives": dict(probe.collectives),
            "collectives_in_body": dict(probe.in_body)})
    seen = [outs for outs in outputs.values() if len(outs) > 1]
    report["groups_compared"] = len(seen)
    report["replay_equal"] = bool(seen) and all(
        _tree_equal(outs[0], later) for outs in seen for later in outs[1:])
    k1 = _wrapper_counts()
    report["launches"] = {w: k1[w] - k0[w] for w in k0}
    graphs = []
    if on_card:
        for i, prog in enumerate(cache.graphs()):
            nodes = group_graph_nodes(prog)
            launches = _launch_names(prog.launches)
            findings += graph_findings(name, i, nodes, launches)
            graphs.append({
                "nodes": len(nodes),
                "kernel_nodes": sum(1 for k, _, _ in nodes if k == "kernel"),
                "hand_kernel_nodes": hand_kernel_nodes(nodes),
                "launches": launches,
                "host_bytes": host_constant_bytes(nodes),
                "kinds": sorted({k for k, _, _ in nodes})})
        if len(graphs) != len(outputs):
            raise RuntimeError(
                f"{name}: {len(graphs)} graphs captured for "
                f"{len(outputs)} cached groups")
    report["graphs"] = graphs
    return findings, report


def seeded_host_copy(device="cuda", nbytes: int = 2 << 20):
    """The MDT111 positive: a group body that copies a ``nbytes``
    pinned host tensor to the device inside the capture.  →
    ``(findings, report)`` over its one graph (CUDA only)."""
    import torch

    from mdanalysis_mpi_tpu_torch.parallel.executors import _GroupGraph

    dev = torch.device(device)
    host = torch.ones(nbytes // 4, dtype=torch.float32).pin_memory()
    params = (torch.zeros(nbytes // 4, dtype=torch.float32, device=dev),)

    def body(p, _tot):
        return (p[0] + host.to(dev, non_blocking=True),)

    with GroupProbe():
        prog = _GroupGraph(body, params, None, dev)
    out = prog.replay(params, None, dev)
    torch.cuda.synchronize(dev)
    nodes = group_graph_nodes(prog)
    findings = graph_findings("seeded_host_copy", 0, nodes, {})
    return findings, {"name": "seeded_host_copy",
                      "host_bytes": host_constant_bytes(nodes),
                      "nodes": len(nodes),
                      "kinds": sorted({k for k, _, _ in nodes}),
                      "replay_ok": bool((out[0] == 1).all())}


def registered_programs(device: str = "cuda"):
    """Name → ``(make_analysis, executor, shards, single_device)`` for
    the programs the capture contracts pin, built at a
    small size from the package's synthetic fixtures.  Each groups at
    least two blocks, so a merge per block would show."""
    from mdanalysis_mpi_tpu_torch.analysis import RMSF, AlignedRMSF, InterRDF
    from mdanalysis_mpi_tpu_torch.parallel.executors import (
        DeviceBlockCache, MeshExecutor, TorchExecutor)
    from mdanalysis_mpi_tpu_torch.testing import (
        make_protein_universe, make_water_universe)

    prot = make_protein_universe(n_residues=40, n_frames=64, noise=0.2,
                                 seed=11)
    water = make_water_universe(n_waters=216, n_frames=16, seed=12)
    ow = water.select_atoms("name OW")

    def fresh(u, make):
        def build():
            # the readers' adaptive int16 scale would key a repeat's
            # blocks apart from the cached ones
            u.trajectory.__dict__.pop("_quant_max_hints", None)
            return make()
        return build

    return {
        "mesh_scan_rmsf": (
            fresh(prot, lambda: RMSF(prot.select_atoms("name CA"))),
            MeshExecutor(batch_size=4, devices=[device] * 2, scan_k=2,
                         block_cache=DeviceBlockCache()), 2, False),
        "torch_group_aligned_rmsf_fused": (
            fresh(prot, lambda: AlignedRMSF(prot, select="name CA",
                                            engine="fused")),
            TorchExecutor(batch_size=16, device=device, scan_k=2,
                          transfer_dtype="int16",
                          block_cache=DeviceBlockCache()), 1, True),
        "torch_group_interrdf_kernel": (
            fresh(water, lambda: InterRDF(ow, ow, engine="pallas")),
            TorchExecutor(batch_size=4, device=device, scan_k=2,
                          block_cache=DeviceBlockCache()), 1, True),
    }


def check_captured_programs(notes: list[str], device: str = "cuda"):
    """The MDT110/MDT111 pass over the registered programs on
    ``device`` → ``(findings, reports)``.  A CUDA device must be
    present; ``"cpu"`` checks MDT110 alone."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "the capture contracts run on a CUDA device and none is "
            "present; pass device='cpu' (--device cpu) to check MDT110 "
            "alone with the group bodies run eagerly")
    findings: list[Finding] = []
    reports = []
    for name, (make, exe, shards, single) in \
            registered_programs(device).items():
        f, rep = check_program(name, make, exe, shards=shards,
                               single_device=single)
        findings += f
        reports.append(rep)
    notes.append(f"capture contracts checked {len(reports)} programs on "
                 f"{device}")
    if device == "cpu":
        notes.append("MDT111 not checked: it reads a captured CUDA graph, "
                     "and on the CPU the group bodies run eagerly")
    return findings, reports
