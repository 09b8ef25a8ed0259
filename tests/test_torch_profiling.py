"""The port's profiling helpers (``polar_tpu_torch.utils.profiling``) on the
CPU: ``trace`` writes a Chrome trace that holds an ``annotate`` range and
the operations run inside it."""

import torch

import polar_tpu_torch as pt
from polar_tpu_torch.channel import snr_params
from polar_tpu_torch.ops.cuda import step_kernel
from polar_tpu_torch.utils.profiling import (OWN_KERNEL, annotate,
                                             own_kernels, trace,
                                             trace_events)


def test_trace_holds_the_annotation_and_the_work(tmp_path):
    code = pt.make_code(5, rate=0.5)
    with trace(tmp_path / "t") as prof:
        with annotate("polar_point"):
            step_kernel.step(pt.compile_program(code), code.frozen,
                             snr_params(0.0), True, seeds=(1, 2), batch=64,
                             device="cpu")
    path = prof.trace_file
    assert path.parent == tmp_path / "t" and path.is_file()
    names = [e.get("name") for e in trace_events(path)]
    assert "polar_point" in names
    assert any(n and n.startswith("aten::") for n in names)
    assert own_kernels(path) == []     # no card: the plain version ran


def test_sessions_write_files_of_their_own(tmp_path):
    files = []
    for _ in range(2):
        with trace(tmp_path) as prof:
            torch.ones(4).sum()
        files.append(prof.trace_file)
    assert files[0] != files[1]
    assert sorted(tmp_path.iterdir()) == sorted(files)


def test_annotate_outside_a_session_is_a_no_op():
    with annotate("nothing recording"):
        assert int(torch.ones(3).sum()) == 3


def test_own_kernel_names():
    """The port's kernels sit in their files' anonymous namespaces, torch's
    in at::native, demangled or not."""
    for name in ("(anonymous namespace)::tile_step_kernel<true>(int)",
                 "void (anonymous namespace)::front_rows_kernel(int)",
                 "_ZN12_GLOBAL__N_116count_rows_kernelEv"):
        assert OWN_KERNEL.match(name)
    for name in ("void at::native::vectorized_elementwise_kernel<4>()",
                 "polar_point", "Memcpy HtoD"):
        assert not OWN_KERNEL.match(name)
