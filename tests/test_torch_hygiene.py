"""Import hygiene of the port: maa3_tpu_torch and chip_smoke.py import no
JAX, no Orbax, nothing of the JAX package, no PyYAML, transformers or
tokenizers; orbax_to_torch.py, the one file of the port that imports JAX
and Orbax, takes nothing from maa3_tpu_torch that imports them;
the port's YAML reader agrees with yaml.safe_load on every config; and
chip_smoke.py fails, printing no result, where there is no GPU or no repo."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import yaml

from maa3_tpu_torch.config import load_yaml

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "maa3_tpu", "yaml", "transformers",
           "tokenizers")


def _port_sources():
    return sorted((ROOT / "maa3_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_sources_reference_no_jax_package():
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|orbax|yaml|transformers|"
                     r"tokenizers|maa3_tpu)\b|\bmaa3_tpu\.", re.M)
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in _port_sources() for m in pat.finditer(p.read_text())]
    assert not bad, bad


def test_imports_and_cpu_path_with_blocked_modules(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None          # any import of them now fails
        sys.path.insert(0, {str(ROOT)!r})
        import importlib, pkgutil
        import maa3_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(maa3_tpu_torch.__path__,
                                                       "maa3_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        import torch
        from maa3_tpu_torch.models.bert import BertConfig
        from maa3_tpu_torch.models.bigvgan import BigVGANConfig
        from maa3_tpu_torch.models.clap import CLAPFLANConfig
        from maa3_tpu_torch.models.t5 import T5Config
        from maa3_tpu_torch.system import MAA3System
        up = "model.params.unet_config.params."
        dd = "model.params.first_stage_config.params.ddconfig."
        s = MAA3System.from_config(
            [{str(ROOT / "configs" / "txt2audio-cfm-cfg-XL.yaml")!r}],
            [up + "hidden_size=32", up + "depth=1", up + "num_heads=2",
             up + "context_dim=16", up + "multiple_of=16", dd + "ch=32",
             dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1"],
            device="cpu", unfreeze=True,
            clap_cfg=CLAPFLANConfig(bert=BertConfig(hidden_size=16, num_layers=1,
                                                    num_heads=2, intermediate_size=32),
                                    t5=T5Config(d_model=16, d_kv=8, d_ff=32,
                                                num_layers=1, num_heads=2),
                                    d_proj=16),
            voc_cfg=BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                  upsample_initial_channel=128))
        c = s.get_learned_conditioning(["a bird chirps"])
        uc = s.get_learned_conditioning([""])
        z = s.sample_cfg(c, 5.0, uc, torch.Generator().manual_seed(0),
                         shape=(1, 20, 6), timesteps=3)
        wav = s.vocode(s.decode_first_stage(z))
        assert wav.shape == (1, 48), wav.shape
        leaked = [n for n in sys.modules if n.split(".")[0] in {BLOCKED!r}
                  and sys.modules[n] is not None]
        assert not leaked, leaked
        print("OK", len(names))
    """)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1].startswith("OK")


@pytest.mark.parametrize("module", ["torch_import", "serving", "serve", "train_vae",
                                    "train_vocoder", "mel_spec", "cal_clap_score",
                                    "cal_fd_score", "train_melclf", "predict_melclf",
                                    "structurize_captions", "trace"])
def test_serving_modules_are_among_the_checked_sources(module):
    """The checkpoint import, the server and its CLI, the GAN training and
    mel extraction CLIs, and the evaluation CLIs are among the sources the
    two tests above read and import with JAX blocked."""
    assert ROOT / "maa3_tpu_torch" / f"{module}.py" in _port_sources()


@pytest.mark.parametrize("module", ["diffusion/schedules", "diffusion/ddim",
                                    "diffusion/ddpm_loss", "diffusion/transport",
                                    "diffusion/classifier_guidance", "models/vae2d",
                                    "models/unet2d", "pipeline_audioldm"])
def test_legacy_modules_are_among_the_checked_sources(module):
    """The legacy models and samplers are among the sources the two tests
    above read and import with JAX blocked."""
    assert ROOT / "maa3_tpu_torch" / f"{module}.py" in _port_sources()


def test_converter_takes_nothing_that_imports_jax(tmp_path):
    """Every maa3_tpu_torch module orbax_to_torch.py imports (at the top or
    inside a function) imports with JAX, Orbax and the JAX package blocked."""
    import ast
    tree = ast.parse((ROOT / "orbax_to_torch.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("maa3_tpu_torch"):
            for a in node.names:  # `from pkg import module`, or a name of a module
                sub = f"{node.module}.{a.name}"
                mods.add(sub if (ROOT / (sub.replace(".", "/") + ".py")).exists()
                         else node.module)
        elif isinstance(node, ast.Import):
            mods |= {a.name for a in node.names if a.name.startswith("maa3_tpu_torch")}
    assert {"maa3_tpu_torch.weights", "maa3_tpu_torch.system",
            "maa3_tpu_torch.models.t5"} <= mods, mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        for m in {sorted(mods)!r}:
            importlib.import_module(m)
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr[-3000:]


@pytest.mark.parametrize("module", ["__init__", "mesh", "tp", "fsdp"])
def test_parallel_modules_are_among_the_checked_sources(module):
    """The parallel package (mesh, tensor parallelism, FSDP) is among the
    sources the two tests above read and import with JAX blocked."""
    assert ROOT / "maa3_tpu_torch" / "parallel" / f"{module}.py" in _port_sources()


def test_entry_points_default_to_the_card():
    """Every CLI's --device and every function's `device` default is the
    card ("cuda"); the CPU runs only where the caller asks for it."""
    import importlib
    import inspect
    import pkgutil
    import maa3_tpu_torch
    flags = [(p.name, m.group(0)) for p in (ROOT / "maa3_tpu_torch").rglob("*.py")
             for m in re.finditer(r'add_argument\("--device"[^)]*\)', p.read_text())]
    assert len(flags) >= 12
    assert all('default="cuda"' in f for _, f in flags), flags
    defaults = {}
    for info in pkgutil.walk_packages(maa3_tpu_torch.__path__, "maa3_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            funcs = ([(name, obj)] if inspect.isfunction(obj) else
                     [(f"{name}.{k}", getattr(f, "__func__", f)) for k, f in vars(obj).items()]
                     if inspect.isclass(obj) else [])
            for fname, f in funcs:
                if inspect.isfunction(f):
                    d = inspect.signature(f).parameters.get("device")
                    if d is not None and isinstance(d.default, str):
                        defaults[f"{info.name}.{fname}"] = d.default
    assert "maa3_tpu_torch.system.MAA3System.from_config" in defaults
    assert "maa3_tpu_torch.parallel.mesh.init_distributed" in defaults
    assert set(defaults.values()) == {"cuda"}, defaults


def test_server_runs_with_blocked_modules(tmp_path):
    """A tiny text-to-music system served over HTTP from checkpoint files
    (a Lightning-layout file and a vocoder directory), with JAX, the JAX
    package and PyYAML blocked; shutdown leaves no thread."""
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import json, os, threading, urllib.request
        import torch
        from maa3_tpu_torch.models.bigvgan import BigVGANConfig
        from maa3_tpu_torch.models.bert import BertConfig
        from maa3_tpu_torch.models.clap import CLAPFLANConfig
        from maa3_tpu_torch.models.t5 import T5Config
        from maa3_tpu_torch.serving import AudioServer, ServeConfig
        from maa3_tpu_torch.system import MAA3System
        up = "model.params.unet_config.params."
        dd = "model.params.first_stage_config.params.ddconfig."
        over = [up + "hidden_size=32", up + "depth=1", up + "num_heads=2",
                up + "context_dim=16", up + "multiple_of=16", dd + "ch=32",
                dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1", "model.params.mel_length=4"]
        kw = dict(device="cpu", clap_cfg=CLAPFLANConfig(
            bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32),
            t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2), d_proj=16))
        music = {str(ROOT / "configs" / "txt2music-cfm-cfg.yaml")!r}
        voc = dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
                   upsample_initial_channel=16, resblock_kernel_sizes=[3],
                   resblock_dilation_sizes=[[1, 3]], resblock="2")
        src = MAA3System.from_config([music], over, voc_cfg=BigVGANConfig.from_dict(voc),
                                     unfreeze=True, **kw)
        sd = {{"model.diffusion_model." + k: v for k, v in src.dit.state_dict().items()}}
        sd.update({{"first_stage_model." + k: v for k, v in src.vae.state_dict().items()}})
        sd.update({{"cond_stage_model." + k: v for k, v in src.cond.state_dict().items()}})
        torch.save({{"state_dict": sd}}, "m.ckpt")
        os.makedirs("voc")
        json.dump(voc, open("voc/config.json", "w"))
        torch.save({{"generator": src.vocoder.state_dict()}}, "voc/generator.pt")
        s = MAA3System.from_config([music], over, ckpt_path="m.ckpt", vocoder_dir="voc", **kw)
        before = set(threading.enumerate())
        srv = AudioServer(s, ServeConfig(default_steps=2))
        srv.start()
        req = urllib.request.Request(f"http://127.0.0.1:{{srv.port}}/generate",
                                     data=json.dumps({{"prompt": "a cello"}}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and len(r.read()) == 44 + 2 * 4 * 2 * 4
        srv.shutdown()
        assert set(threading.enumerate()) == before
        leaked = [n for n in sys.modules if n.split(".")[0] in {BLOCKED!r}
                  and sys.modules[n] is not None]
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK"


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_yaml_reader_matches_pyyaml(name):
    text = (ROOT / "configs" / name).read_text()
    assert load_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_subset_matches_pyyaml():
    text = textwrap.dedent("""
        # comment
        a: 1e-6
        b: [1, x, null, ~, True, 0.5, -3, 1_000, .5, -2.5e+3]
        c:
          d: [3, 4]   # trailing comment
          e:
        g: yes
        h: ldm.models.autoencoder1d.AutoencoderKL
    """)
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1", "a: {x: 1}", "a: 'q'", "a: 010",
                                  "a: [[1]]", "a: &x 1"])
def test_yaml_reader_rejects_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        load_yaml(text)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    """Without a GPU; and, with a GPU reported, in a directory that holds
    chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    run = [sys.executable, str(script)]
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        run = [sys.executable, "-c",
               "import runpy, sys, torch; torch.cuda.is_available = lambda: True; "
               "sys.argv = ['chip_smoke.py']; "
               "runpy.run_path('chip_smoke.py', run_name='__main__')"]
    out = subprocess.run(run, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert ("checkout of the repository" if alone else "no CUDA device") in out.stderr


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mangled,short", [
    ("_ZN10maa3_flash12_GLOBAL__N_126flash_fwd_tc_direct_kernelILi72ELi8EEEvNS0_7FwdArgsE",
     "flash_fwd_tc_direct_kernel<72, 8>"),
    ("_ZN10maa3_flash12_GLOBAL__N_125flash_bwd_tc_fused_kernelILi72ELi8EEEvNS0_9BwdTcArgsE",
     "flash_bwd_tc_fused_kernel<72, 8>"),
    ("_ZN10maa3_flash12_GLOBAL__N_123flash_bwd_tc_dkv_kernelILi32ELi2EEEvNS0_9BwdTcArgsE",
     "flash_bwd_tc_dkv_kernel<32, 2>"),
    ("_ZN10maa3_flash12_GLOBAL__N_124flash_bwd_scale_q_kernelILi8EEEvPK13__nv_bfloat16PS2_mf",
     "flash_bwd_scale_q_kernel<8>"),
    ("_ZN10maa3_flash12_GLOBAL__N_116flash_bwd_kernelIfLi72EEEvNS0_7BwdArgsE",
     "flash_bwd_kernel<fp32, 72>"),
    ("_ZN10maa3_flash12_GLOBAL__N_119flash_bwd_dq_kernelI13__nv_bfloat16Li72EEEvNS0_9SplitArgsE",
     "flash_bwd_dq_kernel<bf16, 72>"),
    ("_ZN10maa3_flash12_GLOBAL__N_122flash_bwd_tc_dq_kernelILi72ELi8EEEvNS0_9BwdTcArgsE",
     "flash_bwd_tc_dq_kernel<72, 8>"),
    ("_ZN12_GLOBAL__N_120conv_snake_tc_kernelILi6EEEvNS_8ConvArgsE",
     "conv_snake_tc_kernel<6>"),
    ("_ZN12_GLOBAL__N_117conv_snake_kernelIfEEvPKT_PS1_PKfS6_S6_S6_iiiiibbb",
     "conv_snake_kernel<fp32>"),
    ("_ZN12_GLOBAL__N_115aa_snake_kernelI13__nv_bfloat16EEvPKT_PS2_PKfS7_iiiixxbbb",
     "aa_snake_kernel<bf16>")])
def test_chip_smoke_reads_kernel_names(mangled, short):
    """The SASS check of chip_smoke.py finds the tensor-core kernels by these
    short names (flash_fwd_tc_*, flash_bwd_tc_*, conv_snake_tc_*) and the
    fp32 ones by <fp32."""
    assert _chip_smoke().kernel_name(mangled) == short


_K1_BF16 = "_ZN12_GLOBAL__N_115aa_snake_kernelI13__nv_bfloat16EEvPKT_PS2_PKfS7_iiiixxbbb"
_K1_FP32 = "_ZN12_GLOBAL__N_115aa_snake_kernelIfEEvPKT_PS1_PKfS6_iiiixxbbb"
_K1_RUN = ("_ZN42_INTERNAL_2cb607d8_11_aa_snake_cu_113ee3744maa315act_run_genericILi8E"
           "fN12_GLOBAL__N_17RowTailIfEEEEvPKT0_iiffbT1_")
_PTXAS = f"""ptxas info    : Function properties for {_K1_RUN}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '{_K1_BF16}' for 'sm_90a'
ptxas info    : Function properties for {_K1_BF16}
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '{_K1_FP32}' for 'sm_90a'
ptxas info    : Function properties for {_K1_FP32}
    56 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 97 registers, used 0 barriers, 56 bytes cumulative stack size
"""


@pytest.mark.parametrize("log,ok", [
    (_PTXAS, True),
    # a spill in the fp32 kernel, in the generic run, or a kernel missing
    (_PTXAS.replace("56 bytes stack frame, 0 bytes spill stores",
                    "56 bytes stack frame, 8 bytes spill stores"), False),
    (_PTXAS.replace("0 bytes spill stores, 0 bytes spill loads",
                    "0 bytes spill stores, 4 bytes spill loads", 1), False),
    (_PTXAS.split("ptxas info    : Compiling entry function '" + _K1_FP32)[0], False)])
def test_chip_smoke_requires_k1_without_spills(log, ok):
    """Phase 2 of chip_smoke.py reads ptxas's report per function and fails
    when any function of K1 (its two kernels, the generic run they call)
    spills, or when a K1 kernel is not in the report."""
    cs = _chip_smoke()
    report = cs.ptxas_report(log)
    assert report[_K1_BF16] == {"stack": 32, "spill_stores": 0, "spill_loads": 0,
                                "registers": 58} or not ok
    if ok:
        cs.check_k1_spills(log)
    else:
        with pytest.raises(RuntimeError, match="no spill in any function of K1"):
            cs.check_k1_spills(log)


def _c_kind(decl: str) -> str:
    """The ctypes kind of one C parameter or return type."""
    decl = decl.strip()
    if "*" in decl:
        return "pointer"
    for kind in ("long long", "float", "int"):
        if re.match(rf"(const\s+)?{kind}\b", decl):
            return kind
    raise ValueError(f"unknown C type in {decl!r}")


def _extern_c_functions():
    """{name: (return kind, [argument kinds])} of every extern "C" function in
    maa3_tpu_torch/csrc/*.cu."""
    pat = re.compile(r'extern\s+"C"\s+([\w\s]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)
    out = {}
    for path in sorted((ROOT / "maa3_tpu_torch" / "csrc").glob("*.cu")):
        for ret, name, args in pat.findall(path.read_text()):
            out[name] = (_c_kind(ret), [_c_kind(a) for a in args.split(",")])
    return out


def test_ctypes_bindings_match_the_c_signatures():
    """cuda.SIGNATURES binds every extern "C" function of the sources with the
    same number and kinds of arguments, and the same return kind, so a
    changed C signature fails here instead of misreading arguments on the
    card (ctypes passes whatever the argtypes say)."""
    import ctypes
    from maa3_tpu_torch import cuda
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_float: "float", ctypes.c_longlong: "long long"}
    c_funcs = _extern_c_functions()
    assert len(c_funcs) >= 7, sorted(c_funcs)
    assert sorted(c_funcs) == sorted(cuda.SIGNATURES)
    for name, (ret, args) in c_funcs.items():
        restype, argtypes = cuda.SIGNATURES[name]
        assert (kinds[restype], [kinds[t] for t in argtypes]) == (ret, args), name
