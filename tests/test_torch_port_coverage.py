"""The port covers the JAX package: every module, public name, CLI flag
and TPU kernel of ``multimodalfusion_tpu`` has its counterpart in
``multimodalfusion_tpu_torch``.

Read with ``ast`` and the file system only: neither package is imported.
A name or module that the port replaces by design stands in ``EXEMPT`` or
``MODULES_KEPT_OUT`` with its counterpart, as ``"path.py:Qual.name"`` in
the port (checked to exist) or as ``"ROADMAP.md: phrase"`` (checked to be
in ROADMAP.md); an entry that goes stale fails here too."""
import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "multimodalfusion_tpu")
PORT = os.path.join(ROOT, "multimodalfusion_tpu_torch")

# ROADMAP.md's decision on resume bundles, which replaces orbax
RESUME_BUNDLE = ("ROADMAP.md: The resume bundle is the port's `.pt`, under "
                 "either `--ckpt_format`")

# JAX modules with no port module of the same path
MODULES_KEPT_OUT = {
    "utils/orbax_io.py": (RESUME_BUNDLE, "engine/train.py:save_resume"),
    "utils/torch_interop.py": (
        "ROADMAP.md: `utils/torch_interop.py`, because the port reads and "
        "writes the reference layout itself", "utils/params.py:build_spec"),
}

# public names of a JAX module that its port module does not define, each
# with what takes its place
EXEMPT = {
    "cli/doctor.py": {
        "check_platform": ("cli/doctor.py:Doctor.platform",),
        "check_native": ("cli/doctor.py:Doctor.native",),
        "check_optional": ("cli/doctor.py:Doctor.optional",),
        "check_io": ("cli/doctor.py:Doctor.io",),
        "check_numerics": ("cli/doctor.py:Doctor.numerics",),
    },
    "models/resnet.py": {
        # the port loads torchvision's layout as it is; the tests carry
        # JAX's variables across with the inverse
        "port_torch_state_dict": (
            "utils/params.py:resnet_state_dict_from_flax",),
    },
    "native.py": {
        "get_lib": ("native.py:lib",),
        "pad_bags_native": ("native.py:pad_bags_into",
                            "data/bags.py:pad_bags"),
    },
    "ops/mil_attention.py": {
        "force_unfused": ("ops/mil_attention.py:pooling_route",),
    },
    "utils/model_export.py": {
        "traces_fused": ("utils/model_export.py:keeps_kernel",
                         "ops/mil_attention.py:fused_pool_op"),
    },
    "ops/sharded_pool.py": {
        "sharded_attention_pool": ("ops/mil_attention.py:attention_pool",
                                   "ops/sharded_pool.py:merge"),
        "bag_sharded_put": ("data/loaders.py:iter_batches",
                            "parallel/mesh.py:block"),
    },
    "parallel/mesh.py": {
        "batch_sharding": ("parallel/mesh.py:block",),
        "replicate_sharding": ("parallel/mesh.py:sum_gradients",),
        "shard_batch": ("data/loaders.py:iter_batches",
                        "parallel/mesh.py:block"),
        "shard_batch_bags": ("data/loaders.py:iter_batches",),
        "shard_batch_dp_bags": ("data/loaders.py:iter_batches",
                                "parallel/mesh.py:make_dp_bag_mesh"),
        "pad_batch_to_devices": ("data/loaders.py:iter_batches",
                                 "ROADMAP.md: JAX's `shard_batch*` and "
                                 "`pad_batch_to_devices` are the loader's "
                                 "cut of each batch"),
    },
    "utils/orbax_io.py": {
        "save_tree": ("engine/train.py:save_resume",),
        "restore_tree": ("engine/train.py:load_resume",),
        "exists": (RESUME_BUNDLE,),
    },
    "utils/torch_interop.py": {
        "build_spec": ("utils/params.py:build_spec",),
        "spec_from_config": ("utils/params.py:spec_from_config",),
        "torch_to_variables": ("engine/train.py:load_checkpoint",),
        "variables_to_torch": ("utils/params.py:state_dict_from_jax",),
        "torch_to_flax": ("engine/train.py:load_checkpoint",),
        "flax_to_torch": ("utils/params.py:state_dict_from_jax",),
        "export_pt": ("engine/train.py:save_checkpoint",),
        "import_pt": ("engine/train.py:load_checkpoint",),
    },
}

# the JAX package's pallas_call sites: (module, enclosing function) ->
# the kernel it launches
PALLAS_SITES = {
    ("ops/mil_attention.py", "_fused_pool_pallas"): "_fused_pool_kernel",
    ("ops/mil_attention.py", "_fused_pool_bwd_pallas"):
        "_fused_pool_bwd_kernel",
}


def _modules(pkg):
    return sorted(os.path.relpath(os.path.join(d, f), pkg).replace(os.sep,
                                                                   "/")
                  for d, _, files in os.walk(pkg) for f in files
                  if f.endswith(".py"))


def _tree(pkg, rel):
    with open(os.path.join(pkg, rel)) as f:
        return ast.parse(f.read())


def _top_names(tree):
    return {n.name for n in tree.body if isinstance(
        n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _public(pkg, rel):
    return {n for n in _top_names(_tree(pkg, rel)) if not n.startswith("_")}


def _roadmap():
    with open(os.path.join(ROOT, "ROADMAP.md")) as f:
        return " ".join(f.read().split())


def _resolves(ref):
    """Whether ``ref`` ("ROADMAP.md: phrase" or "path.py:Qual.name" in the
    port) names something that exists."""
    if ref.startswith("ROADMAP.md: "):
        return " ".join(ref[len("ROADMAP.md: "):].split()) in _roadmap()
    rel, qual = ref.split(":")
    if not os.path.exists(os.path.join(PORT, rel)):
        return False
    body = _tree(PORT, rel).body
    for part in qual.split("."):
        found = [n for n in body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and n.name == part]
        if not found:
            return False
        body = found[0].body
    return True


JAX_MODULES = _modules(JAX)
JAX_CLIS = [m for m in JAX_MODULES
            if m.startswith("cli/") and m != "cli/__init__.py"]
EXEMPT_ENTRIES = [(m, n) for m, names in EXEMPT.items() for n in names]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_has_its_port(rel):
    if rel in MODULES_KEPT_OUT:
        assert not os.path.exists(os.path.join(PORT, rel)), (
            f"{rel} now has a port module: drop it from MODULES_KEPT_OUT")
        assert all(_resolves(r) for r in MODULES_KEPT_OUT[rel])
        return
    assert os.path.exists(os.path.join(PORT, rel)), (
        f"multimodalfusion_tpu/{rel} has no port module")


def test_modules_kept_out_are_jax_modules():
    assert set(MODULES_KEPT_OUT) <= set(JAX_MODULES)
    assert set(EXEMPT) <= set(JAX_MODULES)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_its_port(rel):
    port = (set() if rel in MODULES_KEPT_OUT
            else _top_names(_tree(PORT, rel)))
    missing = _public(JAX, rel) - port - set(EXEMPT.get(rel, {}))
    assert not missing, (f"multimodalfusion_tpu/{rel}: {sorted(missing)} "
                         f"have no counterpart of the same name in the port")


@pytest.mark.parametrize("rel,name", EXEMPT_ENTRIES,
                         ids=[f"{m}:{n}" for m, n in EXEMPT_ENTRIES])
def test_exemption_is_current_and_names_its_counterpart(rel, name):
    assert name in _public(JAX, rel), (
        f"stale exemption: multimodalfusion_tpu/{rel} has no {name}")
    if rel not in MODULES_KEPT_OUT:
        assert name not in _top_names(_tree(PORT, rel)), (
            f"stale exemption: the port's {rel} now defines {name}")
    refs = EXEMPT[rel][name]
    assert refs and all(_resolves(r) for r in refs), refs


def test_exemption_table_holds_only_the_listed_names():
    assert len(EXEMPT_ENTRIES) == 29
    ported = {("native.py", "f32_to_bf16"), ("native.py", "read_files"),
              ("metrics.py", "survival_probs_at_times"),
              ("utils/experiment.py", "find_settings")}
    assert not ported & set(EXEMPT_ENTRIES)


def _flags(tree):
    """Every option string of every ``add_argument`` call; a non-literal
    one is returned as None, which no port flag can match."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "add_argument":
            for a in node.args:
                ok = isinstance(a, ast.Constant) and isinstance(a.value, str)
                out.add(a.value if ok else None)
    return out


@pytest.mark.parametrize("rel", JAX_CLIS)
def test_port_cli_takes_every_jax_flag(rel):
    want = _flags(_tree(JAX, rel))
    assert None not in want, f"{rel}: an add_argument option is not literal"
    assert want, f"{rel} defines no option"
    missing = want - _flags(_tree(PORT, rel))
    assert not missing, (f"the port's {rel} lacks {sorted(missing)} of the "
                         f"JAX CLI")


def _pallas_sites():
    """(module, enclosing top-level function) -> (line of pallas_call, the
    module-level ``*_kernel`` functions that function names)."""
    sites = {}
    for rel in JAX_MODULES:
        tree = _tree(JAX, rel)
        kernels = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)}
        for fn in tree.body:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and (
                        getattr(node.func, "attr", None) == "pallas_call"
                        or getattr(node.func, "id", None) == "pallas_call"):
                    used = {n.id for n in ast.walk(fn)
                            if isinstance(n, ast.Name) and n.id in kernels
                            and n.id.endswith("_kernel")}
                    name = getattr(fn, "name", None)
                    assert (rel, name) not in sites, (rel, name)
                    sites[(rel, name)] = (node.lineno, used)
    return sites


def test_jax_package_has_exactly_the_two_pallas_sites():
    sites = _pallas_sites()
    assert set(sites) == set(PALLAS_SITES), sorted(sites)
    assert sorted(line for line, _ in sites.values()) == [334, 545]
    for key, kernel in PALLAS_SITES.items():
        assert sites[key][1] == {kernel}, (key, sites[key])


def _cu_headers():
    """Each ``csrc/*.cu`` file's leading comment block."""
    out = {}
    csrc = os.path.join(PORT, "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                head = []
                for line in fh:
                    if not line.startswith("//"):
                        break
                    head.append(line)
            out[f] = "".join(head)
    return out


def _chip_smoke_kernels():
    """chip_smoke.py's KERNELS table, read as a literal."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "KERNELS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no KERNELS table")


@pytest.mark.parametrize("site", sorted(PALLAS_SITES),
                         ids=[k for _, k in sorted(PALLAS_SITES.items())])
def test_every_pallas_kernel_has_a_cuda_port(site):
    """A csrc/*.cu header names the kernel it replaces, and chip_smoke.py's
    line for that source points at the kernel's definition."""
    kernel = PALLAS_SITES[site]
    pattern = re.compile(r"Replaces the TPU kernel `" + kernel + "`")
    sources = [f for f, head in _cu_headers().items()
               if pattern.search(" ".join(head.replace("//", " ").split()))]
    assert len(sources) == 1, (kernel, sources)
    tree = _tree(JAX, site[0])
    line = next(n.lineno for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == kernel)
    entry = [k for k in _chip_smoke_kernels().values()
             if k["source"].endswith("csrc/" + sources[0])]
    assert len(entry) == 1 and entry[0]["route"] == "cuda"
    assert entry[0]["replaces"] == \
        f"multimodalfusion_tpu/{site[0]}:{line}", entry
