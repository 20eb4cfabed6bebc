"""The step kinds and eval modes that the card checks drive, in one place.

``chip_smoke.py`` (its NCCL step kinds and split frames, the demo's launch
counts) and ``tests/test_torch_gpu.py`` (the compiled epoch and frame
against their loops) both read these tables, so a new step kind or eval
mode is written once.  Plain data: importing this needs no card.
"""

# the coarse-free hybrid on the bitpacked map: two-pass GLOBAL_OPTIM,
# coarse-free from FINE_TUNE (stage 2), 8 uniform samples a ray
COARSE_FREE = {"coarse_free": True, "coarse_free_from_stage": 2, "cf_uniform_samples": 8,
               "occ_map_dtype": "bitpack"}

# the main path's step kinds: (stage, the train config's and the NeRF
# config's changes from Config())
STEP_KINDS = {"importance GLOBAL_OPTIM": (1, {}, {}),
              "grid GLOBAL_OPTIM": (1, {"fine_mode": "grid"}, {}),
              "coarse-free FINE_TUNE": (2, {}, COARSE_FREE),
              "CAM_PARAM": (0, {}, {})}

# the eval modes of a frame: (the eval config's and the NeRF config's
# changes from Config(), whether a fresh map is refreshed from the weights)
FRAME_MODES = {"importance culled": ({}, {}, True),
               "importance unculled": ({}, {}, False),
               "coarse-free bitpack": ({}, {"coarse_free": True, "occ_map_dtype": "bitpack"},
                                       True),
               "grid": ({"fine_mode": "grid"}, {}, False)}

# each eval mode's launches of each eval wrapper a chunk (a block of a
# split frame): K1 the coarse pass, K2 or K4 the fine one; sample_pdf's
# draws of the coarse depths from the map's PMF and of the fine ones
FRAME_LAUNCHES = {"importance culled": {"fused_mlp_apply_rays": 1, "fused_render_rays": 1,
                                        "sample_pdf_cuda": 2},
                  "importance unculled": {"fused_mlp_apply_rays": 1, "fused_render_rays": 1,
                                          "sample_pdf_cuda": 1},
                  "coarse-free bitpack": {"fused_render_rays": 1, "sample_pdf_cuda": 1},
                  "grid": {"fused_mlp_apply_rays": 1, "fused_shaded_mlp_rays": 1}}
