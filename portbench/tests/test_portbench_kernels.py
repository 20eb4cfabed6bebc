"""Kernel-to-layer classification from the files under kernels/."""

import json

import pytest

from portbench import profiling


def write(d, name, layer, kernels):
    (d / name).write_text(json.dumps({"layer": layer, "kernels": kernels}))


def test_several_files_and_glue(tmp_path):
    write(tmp_path, "a_hand.json", "kernels", ["shaded_fwd_kernel", "mlp_points_kernel"])
    write(tmp_path, "b_nccl.json", "allreduce", ["nccl\\w*"])
    write(tmp_path, "c_later.json", "attention", ["flash_\\w+"])
    maps = profiling.load_layer_maps(tmp_path)
    assert [m[0] for m in maps] == ["kernels", "allreduce", "attention"]
    c = lambda n: profiling.classify(n, maps)
    assert c("void mcn::shaded_fwd_kernel<1>(mcn::MLPParams, mcn::PtArgs)") == "kernels"
    assert c("void mcn::mlp_points_kernel<3>(mcn::MLPParams)") == "kernels"
    assert c("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)") \
        == "allreduce"
    assert c("flash_fwd_kernel") == "attention"
    assert c("void at::native::vectorized_elementwise_kernel<4>") == "glue"
    # a name is matched as a word: a longer kernel name is not this one
    assert c("void mcn::shaded_fwd_kernel_v2<1>()") == "glue"


def test_the_first_file_by_name_wins(tmp_path):
    write(tmp_path, "b.json", "second", ["k"])
    write(tmp_path, "a.json", "first", ["k"])
    assert profiling.classify("void k()", profiling.load_layer_maps(tmp_path)) == "first"


@pytest.mark.parametrize("name, layer", [
    ("void mcn::shaded_fwd_kernel<0>(mcn::MLPParams, mcn::PtArgs, mcn::PtSchedule)", "kernels"),
    ("mcn::weight_grad_kernel(mcn::WJobs, float*)", "kernels"),
    ("void mcn::composite_fwd_kernel(float const*)", "kernels"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "allreduce"),
    ("Memcpy DtoH (Device -> Pageable)", "glue"),
    ("void at::native::reduce_kernel<512, 1>", "glue"),
])
def test_the_shipped_maps(name, layer):
    assert profiling.classify(name, profiling.load_layer_maps()) == layer
