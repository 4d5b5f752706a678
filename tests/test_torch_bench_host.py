"""The host-loop micro-bench (rend3_tpu_torch.tools.bench_host) on the CPU.

- Its scene at 300 objects, built by the tool's build_scene in both
  packages: the port's evaluate_instructions output equals the JAX
  package's (atlas extent, shadow plan, light arrays and shadow cameras
  bit for bit, the mesh arena too), and so do the object tables the frame
  uploads.
- main() at 300 objects prints the add time, the first evaluate, the first
  upload and the steady loop's min / median / max, and returns 20 times.
  (That it asks for the card without --device is in test_torch_package.py.)
"""

import numpy as np

import rend3_tpu.testing as jax_testing
from rend3_tpu import types as jax_types
from rend3_tpu.utils import math as jax_m3
from rend3_tpu_torch.testing import TestRunner
from rend3_tpu_torch.tools import bench_host

N_OBJECTS = 300


def _evaluate(runner, **modules):
    keep = bench_host.build_scene(runner, N_OBJECTS, **modules)
    runner.renderer.swap_instruction_buffers()
    return keep, runner.renderer.evaluate_instructions()


def test_evaluate_output_matches_jax():
    pr = TestRunner(device="cpu")
    pkeep, pev = _evaluate(pr)
    jr = jax_testing.TestRunner()
    jkeep, jev = _evaluate(jr, types=jax_types, m3=jax_m3)
    assert pev.shadow_atlas_extent == tuple(jev.shadow_atlas_extent)
    assert pev.shadow_plan == jev.shadow_plan and len(pev.shadow_plan) == 1
    for key in ("dir_light_arrays", "point_light_arrays"):
        p, j = getattr(pev, key), getattr(jev, key)
        assert p.keys() == j.keys()
        for k in p:
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(j[k]))
    assert pev.shadow_cameras.keys() == jev.shadow_cameras.keys()
    for li in pev.shadow_cameras:
        np.testing.assert_array_equal(pev.shadow_cameras[li].view_proj(), jev.shadow_cameras[li].view_proj())
    for f in ("position", "normal", "uv0", "color0"):
        np.testing.assert_array_equal(getattr(pev.mesh_buffer, f).numpy(), np.asarray(getattr(jev.mesh_buffer, f)))
    pom, jom = pr.renderer.object_manager, jr.renderer.object_manager
    assert pom.cap >= N_OBJECTS
    for f in ("transforms", "bases", "material_slots", "world_spheres", "enabled"):
        np.testing.assert_array_equal(getattr(pom, f)[:N_OBJECTS], getattr(jom, f)[:N_OBJECTS])
    del pkeep, jkeep


def test_main_prints_its_lines(capsys):
    res = bench_host.main([str(N_OBJECTS), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"added {N_OBJECTS} objects in ")
    assert out[1].startswith("first evaluate_instructions: ")
    assert out[2].startswith("first BaseRenderGraph._upload: ")
    assert out[3].startswith(f"steady-state host loop over {N_OBJECTS} objects (cpu): min ")
    assert "median" in out[3] and "max" in out[3]
    assert len(res["ms"]) == bench_host.ITERS and all(t > 0 for t in res["ms"])
