"""Bench scenes: the city-block proxy of bench.py, built through the port.

Port of bench.py's `build_city_scene` (bench.py:29-258): the same calls on
the runner in the same order from the same seed, so the JAX package and the
port render the same scene. `representative=False` is the flat variant that
`bench.py --flat` times: subdivided-cube buildings with flat lit PBR
materials, a ground plane and one shadowed directional light.
`textured_city` cuts the representative scene down to its textured, opaque
part; `feature_city` adds the frame's extension features to it (a skybox,
skinned columns, registered material routines, injected passes).
`textured_planes` is a small scene that drives every texture branch of the
shader; `stacked_cutout`, `glass_stack` and `peel_slice` are small cutout,
blend and whole-slice scenes (the first two those of tests/test_caps.py and
tests/test_blend.py); `skinned_columns`, `registry_scene` and
`skybox_cube` small skinning, routine and skybox scenes; `shadow_cube`,
`band_features` and `mipmapped_floor` the scenes of tests/test_multichip.py
(the row bands' tests); `rich_scene` the graft entry points' scene
(__graft_entry__._build_rich_scene). The small scenes take the modules
they build with, so another package can build the same scene.
"""

import numpy as np

__all__ = [
    "build_city_scene", "textured_city", "textured_planes", "stacked_cutout", "glass_stack", "peel_slice",
    "set_bench_camera", "skinned_column_mesh", "column_pose", "add_skinned_columns", "pose_columns",
    "skinned_columns", "flat_material_class", "registry_scene", "skybox_cube", "sky_faces", "feature_city",
    "shadow_cube", "band_features", "mipmapped_floor", "rich_scene",
]


def _subdivided_cube(g: int) -> tuple:
    """A [-1,1] cube with each face split into a g x g quad grid
    (6*g*g*2 triangles) — gives the proxy scene Bistro-like triangle
    density without external assets."""
    verts = []
    idx = []
    axes = [  # (normal axis, u axis, v axis, sign)
        (0, 1, 2, +1), (0, 1, 2, -1),
        (1, 0, 2, +1), (1, 0, 2, -1),
        (2, 0, 1, +1), (2, 0, 1, -1),
    ]
    uvs = []
    for (na, ua, va, sgn) in axes:
        base = len(verts)
        for j in range(g + 1):
            for i in range(g + 1):
                p = [0.0, 0.0, 0.0]
                p[na] = float(sgn)
                p[ua] = -1.0 + 2.0 * i / g
                p[va] = -1.0 + 2.0 * j / g
                verts.append(p)
                uvs.append([i / g, j / g])
        for j in range(g):
            for i in range(g):
                a = base + j * (g + 1) + i
                b = a + 1
                c = a + (g + 1)
                d = c + 1
                if sgn > 0:
                    idx += [a, b, d, d, c, a]
                else:
                    idx += [a, d, b, d, a, c]
    return np.asarray(verts, np.float32), np.asarray(idx, np.uint32), np.asarray(uvs, np.float32)


def _proc_texture(rng, kind, size=128):
    """Procedural RGBA8 texture: brick-ish checker / noise / foliage alpha."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.zeros((size, size, 4), np.uint8)
    if kind == "albedo":
        base = rng.uniform(0.25, 0.85, 3)
        checker = (((xx // 16) + (yy // 8)) % 2).astype(np.float32)
        mortar = ((xx % 16 < 1) | (yy % 8 < 1)).astype(np.float32)
        c = base[None, None] * (0.75 + 0.25 * checker[..., None])
        c = c * (1.0 - 0.5 * mortar[..., None])
        img[..., :3] = np.clip(c * 255, 0, 255).astype(np.uint8)
        img[..., 3] = 255
    elif kind == "aomr":
        img[..., 0] = 255                                      # AO
        img[..., 1] = (rng.uniform(0.4, 0.9) * 255)            # roughness
        img[..., 2] = 0                                        # metallic
        img[..., 3] = 255
    elif kind == "leaf":
        cx = size / 2
        r = np.sqrt((xx - cx) ** 2 + (yy - cx) ** 2) / cx
        blob = (r + 0.35 * np.sin(np.arctan2(yy - cx, xx - cx) * 7.0)) < 0.9
        green = rng.uniform(0.3, 0.7)
        img[..., 0] = 30
        img[..., 1] = int(green * 255)
        img[..., 2] = 25
        img[..., 3] = np.where(blob, 255, 0)
    return img


def build_city_scene(runner, n_buildings=600, seed=7, subdiv=3, representative=True):
    """City block: ground + subdivided-cube buildings (~230k scene tris).

    representative adds what the Bistro north-star actually stresses
    (VERDICT round 1): textured PBR materials through the atlas sampler,
    alpha-tested foliage, alpha-blended glass panes, and a second shadowed
    directional light."""
    from .routine.pbr.material import (
        AlbedoComponent, AoMRTextures, PbrMaterial, Transparency,
    )
    from .types import (
        Handedness, MeshBuilder, MipmapCount, Object, StaticMeshKind, Texture,
        TextureFormat,
    )
    from .utils import math as m3

    rng = np.random.default_rng(seed)
    keep = []

    ground = runner.add_lit_material([0.35, 0.35, 0.33, 1.0])
    keep.append(ground)
    keep.append(runner.plane(ground, m3.rotation_x(-np.pi / 2) @ m3.scale(400.0)))

    r = runner.renderer
    mats = []
    if representative:
        for _ in range(24):
            alb = r.add_texture_2d(Texture(
                label="alb", data=_proc_texture(rng, "albedo"),
                format=TextureFormat.RGBA8_UNORM_SRGB, mip_count=MipmapCount.MAXIMUM))
            aomr = r.add_texture_2d(Texture(
                label="aomr", data=_proc_texture(rng, "aomr"),
                format=TextureFormat.RGBA8_UNORM, mip_count=MipmapCount.MAXIMUM))
            m = r.add_material(PbrMaterial(
                albedo=AlbedoComponent.new_texture(alb),
                aomr_textures=AoMRTextures(mode="combined", aomr_texture=aomr),
            ))
            keep.extend([alb, aomr, m])
            mats.append(m)
    else:
        for _ in range(64):
            c = rng.uniform(0.2, 0.9, 3)
            m = runner.add_lit_material([*c, 1.0])
            mats.append(m)
            keep.append(m)

    # A few shared building meshes with different tessellation.
    meshes = []
    for g in (subdiv, subdiv + 1, subdiv + 2):
        v, i, uv = _subdivided_cube(g)
        meshes.append(runner.add_mesh(
            MeshBuilder(v, Handedness.LEFT).with_vertex_uv0(uv).with_indices(i).build()
        ))
    keep.extend(meshes)

    side = int(np.ceil(np.sqrt(n_buildings)))
    for i in range(n_buildings):
        gx, gz = i % side, i // side
        x = (gx - side / 2) * 8.0 + rng.uniform(-1, 1)
        z = (gz - side / 2) * 8.0 + rng.uniform(-1, 1)
        h = rng.uniform(2.0, 18.0)
        w = rng.uniform(1.5, 3.5)
        t = m3.translation([x, h, z]) @ m3.scale([w, h, w])
        keep.append(
            runner.add_object(
                Object(mesh_kind=StaticMeshKind(meshes[i % len(meshes)]), material=mats[i % len(mats)], transform=t)
            )
        )

    if representative:
        # Alpha-tested foliage: crossed quads with a leaf-alpha texture.
        quad_v = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float32)
        quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        quad_i = np.array([0, 1, 2, 2, 3, 0, 0, 2, 1, 2, 0, 3], np.uint32)  # double-sided
        quad = r.add_mesh(
            MeshBuilder(quad_v, Handedness.LEFT).with_vertex_uv0(quad_uv).with_indices(quad_i).build()
        )
        keep.append(quad)
        leaf_mats = []
        for _ in range(4):
            leaf = r.add_texture_2d(Texture(
                label="leaf", data=_proc_texture(rng, "leaf"),
                format=TextureFormat.RGBA8_UNORM_SRGB, mip_count=MipmapCount.MAXIMUM))
            lm = r.add_material(PbrMaterial(
                albedo=AlbedoComponent.new_texture(leaf),
                transparency=Transparency.cutout_at(0.5),
            ))
            keep.extend([leaf, lm])
            leaf_mats.append(lm)
        for i in range(150):
            x = rng.uniform(-side * 4.0, side * 4.0)
            z = rng.uniform(-side * 4.0, side * 4.0)
            s = rng.uniform(1.5, 3.0)
            base = m3.translation([x, s, z]) @ m3.scale(s)
            for rot in (0.0, np.pi / 2):
                keep.append(r.add_object(Object(
                    mesh_kind=StaticMeshKind(quad), material=leaf_mats[i % 4],
                    transform=base @ m3.rotation_y(rot))))

        # A deliberate foliage row near the camera target so cutout carries
        # real load in the benched view (VERDICT r4 weak #4: only ~70
        # surviving cutout triangles from the bench camera).
        for i in range(20):
            x = rng.uniform(-8.0, 12.0)
            z = rng.uniform(-8.0, 12.0)
            s = rng.uniform(1.5, 3.0)
            base = m3.translation([x, s, z]) @ m3.scale(s)
            for rot in (0.0, np.pi / 2):
                keep.append(r.add_object(Object(
                    mesh_kind=StaticMeshKind(quad), material=leaf_mats[i % 4],
                    transform=base @ m3.rotation_y(rot))))

        # Glass panes (alpha blended).
        glass = r.add_material(PbrMaterial(
            albedo=AlbedoComponent.new_value(np.array([0.4, 0.7, 0.9, 0.35], np.float32)),
            transparency=Transparency.blend(),
        ))
        keep.append(glass)
        for i in range(12):
            x = rng.uniform(-20.0, 20.0)
            z = rng.uniform(-30.0, 10.0)
            s = rng.uniform(2.0, 4.0)
            keep.append(r.add_object(Object(
                mesh_kind=StaticMeshKind(quad), material=glass,
                transform=m3.translation([x, s, z]) @ m3.scale(s))))
        # Storefront panes ON the bench camera's sight line ([40,30,-60] ->
        # [0,5,0]) so blend shading/compositing is actually exercised by the
        # headline number (VERDICT r4 weak #4: the random panes above are all
        # occluded from the bench camera — blend_px_need was 0). The pair at
        # z=-30/-29 overlaps from that camera: real multi-layer blending.
        for (px, py, pz), s in (
            ((26.0, 21.0, -39.0), 5.0),
            ((20.0, 17.5, -30.0), 4.0),
            ((20.5, 17.2, -29.0), 3.0),
            ((14.0, 14.0, -21.0), 3.5),
        ):
            keep.append(r.add_object(Object(
                mesh_kind=StaticMeshKind(quad), material=glass,
                transform=m3.translation([px, py, pz]) @ m3.scale(s))))

    from .types import DirectionalLight

    keep.append(
        runner.renderer.add_directional_light(
            DirectionalLight(
                color=np.ones(3, np.float32),
                intensity=4.0,
                direction=np.array([-0.7, -1.0, 0.4], np.float32),
                distance=300.0,
                resolution=2048,
            )
        )
    )
    if representative:
        keep.append(
            runner.renderer.add_directional_light(
                DirectionalLight(
                    color=np.array([0.9, 0.7, 0.5], np.float32),
                    intensity=1.5,
                    direction=np.array([0.5, -0.8, -0.6], np.float32),
                    distance=300.0,
                    resolution=1024,
                )
            )
        )
    return keep


def textured_city(runner, n_buildings=600, seed=7, build=None):
    """The textured city: build_city_scene(representative=True) without its
    alpha-tested foliage and alpha-blended glass objects (the object handles
    that follow the quad mesh). Dropping those handles deletes the objects
    through the handle API; two instruction rounds apply the deletes and
    reclaim the slots (one frame late, as the reference does), so the first
    rendered frame already sees the final triangle table. The leaf textures,
    the leaf and glass materials and both lights stay registered, so the
    texture atlas is the representative scene's. `build` may be the JAX
    package's bench.build_city_scene, for the same scene there. Returns the
    handles to keep."""
    keep = (build or build_city_scene)(runner, n_buildings=n_buildings, seed=seed, representative=True)
    kinds = [getattr(h, "kind", None) for h in keep]
    quad = max(i for i, k in enumerate(kinds) if k == "mesh")
    keep = [h for i, (h, k) in enumerate(zip(keep, kinds)) if i <= quad or k != "object"]
    for _ in range(2):
        runner.renderer.swap_instruction_buffers()
        runner.renderer.evaluate_instructions()
    return keep


def _modules(mat, types, m3):
    """The material, types and math modules a scene is built with: the
    port's own unless another package's are given."""
    if mat is None:
        from .routine.pbr import material as mat
    if types is None:
        from . import types
    if m3 is None:
        from .utils import math as m3
    return mat, types, m3


def _quad_mesh(r, types, double_sided=False, z=0.0, s=1.0):
    """A [-s, s] quad at depth z facing a camera at -z, with uv0."""
    v = np.array([[-s, s, z], [s, s, z], [s, -s, z], [-s, -s, z]], np.float32)
    idx = [0, 1, 2, 2, 3, 0] + ([0, 2, 1, 2, 0, 3] if double_sided else [])
    return r.add_mesh(
        types.MeshBuilder(v, types.Handedness.LEFT)
        .with_vertex_uv0(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
        .with_indices(np.array(idx, np.uint32))
        .build()
    )


def stacked_cutout(runner, mat=None, types=None, m3=None):
    """tests/test_caps.py:248-318's scene: two fully alpha-failing lit
    cutout quads in front of a passing red one, a blue lit backdrop and
    one shadowed light (three cutout peels). Modules as in textured_planes.
    Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    r = runner.renderer
    keep = [runner.add_directional_light(np.array([0.0, -1.0, 0.5], np.float32))]
    mat_bg = runner.add_lit_material([0.0, 0.0, 1.0, 1.0])
    keep += [mat_bg, runner.plane(mat_bg, m3.translation([0.0, 0.0, 1.0]))]
    mats = []
    for alpha in (0, 255):
        data = np.zeros((8, 8, 4), np.uint8)
        data[..., 0] = 255
        data[..., 3] = alpha
        t = r.add_texture_2d(types.Texture(
            label=f"a{alpha}", data=data, format=types.TextureFormat.RGBA8_UNORM_SRGB,
            mip_count=types.MipmapCount.ONE,
        ))
        mats.append(r.add_material(mat.PbrMaterial(
            albedo=mat.AlbedoComponent.new_texture(t), transparency=mat.Transparency.cutout_at(0.5),
        )))
        keep.append(t)
    quad = _quad_mesh(r, types)
    keep += mats + [quad]
    for z, m in ((-1.0, mats[0]), (-0.6, mats[0]), (-0.2, mats[1])):
        keep.append(r.add_object(types.Object(
            mesh_kind=types.StaticMeshKind(quad), material=m, transform=m3.translation([0.0, 0.0, z]),
        )))
    runner.set_camera_data(types.Camera(
        projection=types.Orthographic(size=np.array([2.5, 2.5, 8.0], np.float32)),
        view=m3.look_at_lh([0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


GLASS_LAYERS = (
    (0.4, 1.0, (1.0, 0.1, 0.1, 0.5)),
    (0.6, 0.6, (0.1, 1.0, 0.1, 0.4)),
    (0.8, 0.35, (0.1, 0.1, 1.0, 0.7)),
)


def glass_stack(runner, layers=GLASS_LAYERS, mat=None, types=None, m3=None):
    """tests/test_blend.py's scene: unlit alpha-blended quads given as
    (z, half size, rgba), in front of an opaque backstop over the lower
    half, seen orthographically. Modules as in textured_planes. Returns the
    handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    r = runner.renderer
    keep = []
    for z, s, rgba in layers:
        m = r.add_material(mat.PbrMaterial(
            albedo=mat.AlbedoComponent.new_value(np.array(rgba, np.float32)), unlit=True,
            transparency=mat.Transparency.blend(),
        ))
        mesh = _quad_mesh(r, types, z=z, s=s)
        keep += [m, mesh, r.add_object(types.Object(
            mesh_kind=types.StaticMeshKind(mesh), material=m, transform=np.eye(4, dtype=np.float32),
        ))]
    solid = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_value(np.array([0.8, 0.8, 0.2, 1.0], np.float32)), unlit=True,
    ))
    mesh = _quad_mesh(r, types, z=0.95, s=0.8)
    keep += [solid, mesh, r.add_object(types.Object(
        mesh_kind=types.StaticMeshKind(mesh), material=solid, transform=m3.translation([0.0, -0.8, 0.0]),
    ))]
    runner.set_camera_data(types.Camera(
        projection=types.Orthographic(size=np.array([2.0, 2.0, 8.0], np.float32)),
        view=m3.look_at_lh([0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def peel_slice(runner, mat=None, types=None, m3=None):
    """A small scene of the whole bench slice: a lit ground, two crossing
    double-sided leaf quads (textured, alpha cutout at 0.5), two glass panes
    that overlap from the camera (one with a textured albedo) and two
    shadowed directional lights, in perspective. Modules as in
    textured_planes. Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    r = runner.renderer
    keep = [
        runner.add_directional_light(np.array([-0.7, -1.0, 0.4], np.float32)),
        runner.add_directional_light(np.array([0.5, -0.8, -0.6], np.float32)),
    ]
    ground = runner.add_lit_material([0.35, 0.35, 0.33, 1.0])
    keep += [ground, runner.plane(ground, m3.rotation_x(-np.pi / 2) @ m3.scale(3.0))]

    yy, xx = np.mgrid[0:32, 0:32]
    rad = np.sqrt((xx - 16.0) ** 2 + (yy - 16.0) ** 2) / 16.0
    leaf_px = np.zeros((32, 32, 4), np.uint8)
    leaf_px[..., 0], leaf_px[..., 1], leaf_px[..., 2] = 30, 160, 25
    leaf_px[..., 3] = np.where(rad + 0.35 * np.sin(np.arctan2(yy - 16.0, xx - 16.0) * 7.0) < 0.9, 255, 0)
    glass_px = np.zeros((32, 32, 4), np.uint8)
    glass_px[..., 0] = 200
    glass_px[..., 1] = np.where((xx // 4) % 2 == 0, 220, 60)
    glass_px[..., 2] = 120
    glass_px[..., 3] = np.where((yy // 8) % 2 == 0, 160, 70)
    texs = [
        r.add_texture_2d(types.Texture(
            label=label, data=px, format=types.TextureFormat.RGBA8_UNORM_SRGB, mip_count=types.MipmapCount.MAXIMUM,
        ))
        for label, px in (("leaf", leaf_px), ("glass", glass_px))
    ]
    leaf = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_texture(texs[0]), transparency=mat.Transparency.cutout_at(0.5),
    ))
    glass = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_value(np.array([0.4, 0.7, 0.9, 0.35], np.float32)),
        transparency=mat.Transparency.blend(),
    ))
    glass_t = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_texture(texs[1]), transparency=mat.Transparency.blend(),
    ))
    quad = _quad_mesh(r, types, double_sided=True)
    keep += texs + [leaf, glass, glass_t, quad]
    base = m3.translation([0.0, 0.8, 0.2]) @ m3.scale(0.8)
    for rot in (0.0, np.pi / 2):
        keep.append(r.add_object(types.Object(
            mesh_kind=types.StaticMeshKind(quad), material=leaf, transform=base @ m3.rotation_y(rot),
        )))
    for m, pos, sc in ((glass, [0.35, 0.75, -0.9], 0.55), (glass_t, [-0.1, 0.6, -1.3], 0.5)):
        keep.append(r.add_object(types.Object(
            mesh_kind=types.StaticMeshKind(quad), material=m, transform=m3.translation(pos) @ m3.scale(sc),
        )))
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=60.0, near=0.1),
        view=m3.look_at_lh([0.4, 1.6, -3.2], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def textured_planes(runner, seed=3, mat=None, types=None, m3=None):
    """Two textured lit quads under one shadowed light, seen at a slant so
    the sampler walks several mips: one with albedo, a tricomponent normal
    map and a combined AO/metallic/roughness texture; one with a swizzled
    bicomponent y-down normal map, bw-split AO / metallic / roughness, and
    emissive and reflectance textures. `mat`, `types` and `m3` are the
    material, types and math modules the scene is built with, the port's
    own by default; another package's modules build the same scene there.
    Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    rng = np.random.default_rng(seed)
    r = runner.renderer
    yy, xx = np.mgrid[0:64, 0:64] / 64.0

    def tex(rgb, srgb=False, alpha=255):
        data = np.empty((64, 64, 4), np.uint8)
        data[..., :3] = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
        data[..., 3] = alpha
        fmt = types.TextureFormat.RGBA8_UNORM_SRGB if srgb else types.TextureFormat.RGBA8_UNORM
        return r.add_texture_2d(types.Texture(label="t", data=data, format=fmt, mip_count=types.MipmapCount.MAXIMUM))

    checker = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2)[..., None]
    noise = rng.uniform(0.0, 1.0, (64, 64, 3))
    bump = np.stack([0.5 + 0.4 * np.sin(xx * 25.0), 0.5 + 0.4 * np.cos(yy * 19.0), np.full_like(xx, 0.8)], -1)
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    albedo = tex(0.3 + 0.5 * checker * noise, srgb=True)
    normal = tex(bump)
    aomr = tex(np.stack([1.0 - 0.5 * checker[..., 0], 0.2 + 0.7 * yy, xx], -1))
    normal2 = tex(np.stack([np.full_like(xx, 0.5), bump[..., 1], bump[..., 0]], -1), alpha=(bump[..., 0] * 255).astype(np.uint8))
    grey = [tex(np.repeat(v[..., None], 3, -1)) for v in (0.3 + 0.7 * xx, yy, 1.0 - 0.6 * checker[..., 0], 0.5 * yy)]
    keep += [albedo, normal, aomr, normal2, *grey]
    mats = [
        r.add_material(mat.PbrMaterial(
            albedo=mat.AlbedoComponent.new_texture(albedo),
            normal=mat.NormalTexture(texture=normal),
            aomr_textures=mat.AoMRTextures(mode="combined", aomr_texture=aomr),
            metallic_factor=0.6,
        )),
        r.add_material(mat.PbrMaterial(
            albedo=mat.AlbedoComponent.new_value(np.array([0.8, 0.6, 0.4, 1.0], np.float32)),
            normal=mat.NormalTexture(texture=normal2, swizzled=True, y_down=True),
            aomr_textures=mat.AoMRTextures(
                mode="bw_split", roughness_texture=grey[0], metallic_texture=grey[1], ao_texture=grey[2],
            ),
            metallic_factor=1.0,
            emissive=mat.MaterialComponent(value=np.array([0.2, 0.1, 0.05], np.float32), texture=grey[3]),
            reflectance=mat.MaterialComponent(value=0.7, texture=grey[1]),
        )),
    ]
    keep += mats
    quad_v = np.array([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]], np.float32)
    quad_uv = np.array([[0, 0], [3, 0], [3, 3], [0, 3]], np.float32)
    quad = r.add_mesh(
        types.MeshBuilder(quad_v, types.Handedness.LEFT)
        .with_vertex_uv0(quad_uv)
        .with_indices(np.array([0, 1, 2, 2, 3, 0], np.uint32))
        .build()
    )
    keep.append(quad)
    caster = runner.add_lit_material([0.7, 0.7, 0.7, 1.0])
    keep += [caster, runner.cube(caster, m3.translation([0.0, 0.5, 0.3]) @ m3.scale(0.2))]
    for m, x in zip(mats, (-1.05, 1.05)):
        keep.append(r.add_object(types.Object(
            mesh_kind=types.StaticMeshKind(quad), material=m, transform=m3.translation([x, 0.0, 0.0]),
        )))
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=60.0, near=0.1),
        view=m3.look_at_lh([0.0, 1.6, -2.0], [0.0, 0.0, 0.3], [0.0, 1.0, 0.0]),
    ))
    return keep


def set_bench_camera(runner, width: int, height: int) -> None:
    """The bench camera (bench.py:335-340)."""
    from .types import Camera, Perspective
    from .utils import math as m3

    runner.set_camera_data(
        Camera(
            projection=Perspective(vfov=60.0, near=0.1),
            view=m3.look_at_lh([40.0, 30.0, -60.0], [0.0, 5.0, 0.0], [0.0, 1.0, 0.0]),
        )
    )
    runner.renderer.set_aspect_ratio(width / height)


# ---------------------------------------------------------------------------
# The frame's extension features: skinning, registered routines, the skybox
# ---------------------------------------------------------------------------


def skinned_column_mesh(types, g: int = 8, joints: int = 4):
    """A subdivided [-1, 1] cube (6*(g+1)^2 vertices, 12*g^2 triangles)
    skinned to `joints` joints spaced evenly along its height: a vertex at
    height y blends the two joints around it linearly."""
    v, i, uv = _subdivided_cube(g)
    s = (v[:, 1] + 1.0) * 0.5 * (joints - 1)
    j0 = np.minimum(np.floor(s), joints - 2).astype(np.int64)
    w1 = (s - j0).astype(np.float32)
    ji = np.zeros((len(v), 4), np.uint16)
    ji[:, 0], ji[:, 1] = j0, j0 + 1
    jw = np.zeros((len(v), 4), np.float32)
    jw[:, 0], jw[:, 1] = 1.0 - w1, w1
    return (
        types.MeshBuilder(v, types.Handedness.LEFT).with_vertex_uv0(uv).with_indices(i)
        .with_vertex_joint_indices(ji).with_vertex_joint_weights(jw).build()
    )


def column_pose(m3, joints: int = 4, bend: float = 0.0, twist: float = 0.0):
    """(global transforms, inverse bind matrices) of a column's joints: joint
    k sits at height -1 + 2k / (joints - 1) and turns by bend * k / (joints
    - 1) about z and twist * k / (joints - 1) about y around that point."""
    g, ib = [], []
    for k in range(joints):
        y = -1.0 + 2.0 * k / (joints - 1)
        a = k / (joints - 1)
        g.append(m3.translation([0.0, y, 0.0]) @ m3.rotation_z(bend * a) @ m3.rotation_y(twist * a))
        ib.append(m3.translation([0.0, -y, 0.0]))
    return np.stack(g).astype(np.float32), np.stack(ib).astype(np.float32)


def add_skinned_columns(runner, placements, material, g=8, joints=4, types=None, m3=None):
    """One skeleton and object per (transform, bend, twist) of
    `placements`, on one shared column mesh; returns (handles to keep,
    skeleton handles)."""
    _mat, types, m3 = _modules(None, types, m3)
    r = runner.renderer
    mesh = r.add_mesh(skinned_column_mesh(types, g, joints))
    keep, skeletons = [mesh], []
    for transform, bend, twist in placements:
        gl, ib = column_pose(m3, joints, bend, twist)
        sk = r.add_skeleton(types.Skeleton(joint_matrices=gl @ ib, mesh=mesh))
        keep += [sk, r.add_object(types.Object(
            mesh_kind=types.AnimatedMeshKind(sk), material=material, transform=transform,
        ))]
        skeletons.append(sk)
    return keep, skeletons


def pose_columns(runner, skeletons, phase: float, joints=4, m3=None):
    """Sets every column's joints through set_skeleton_joint_transforms, a
    bend and twist that vary with the column and `phase`."""
    _mat, _types, m3 = _modules(None, None, m3)
    for k, sk in enumerate(skeletons):
        gl, ib = column_pose(m3, joints, 0.5 * np.sin(phase + 0.7 * k), 0.8 * np.cos(phase + 0.3 * k))
        runner.renderer.set_skeleton_joint_transforms(sk, gl, ib)


def skinned_columns(runner, mat=None, types=None, m3=None):
    """A small skinned scene: a lit ground, three bent columns of one
    skinned mesh (three skeletons, g = 4, 4 joints), one shadowed light, in
    perspective. Modules as in textured_planes. Returns (handles to keep,
    skeleton handles)."""
    mat, types, m3 = _modules(mat, types, m3)
    keep = [runner.add_directional_light(np.array([-0.7, -1.0, 0.4], np.float32))]
    ground = runner.add_lit_material([0.35, 0.35, 0.33, 1.0])
    col = runner.add_lit_material([0.8, 0.4, 0.2, 1.0])
    keep += [ground, col, runner.plane(ground, m3.rotation_x(-np.pi / 2) @ m3.scale(3.0))]
    placements = [
        (m3.translation([x, 0.9, z]) @ m3.scale([0.2, 0.9, 0.2]), bend, twist)
        for x, z, bend, twist in ((-0.8, 0.2, 0.6, 0.0), (0.0, -0.2, -0.4, 0.9), (0.8, 0.3, 0.3, -0.5))
    ]
    k2, skeletons = add_skinned_columns(runner, placements, col, g=4, types=types, m3=m3)
    keep += k2
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=60.0, near=0.1),
        view=m3.look_at_lh([0.4, 1.8, -3.4], [0.0, 0.7, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep, skeletons


def flat_material_class(name: str = "FlatMaterial", blend: bool = False, types=None):
    """A minimal non-PBR material class (tests/test_routine_registry.py:17-52):
    a 4-float rgba data block, no textures; sorted as blended when `blend`.
    The class's name is its archetype."""
    _mat, types, _m3 = _modules(None, types, None)

    def init(self, color):
        self.color = np.asarray(color, np.float32)

    return type(name, (), {
        "__init__": init,
        "required_attributes": classmethod(lambda cls: (types.POSITION,)),
        "supported_attributes": classmethod(lambda cls: (types.POSITION,)),
        "data_size": classmethod(lambda cls: 4),
        "texture_count": classmethod(lambda cls: 0),
        "key": lambda self: 0,
        "sorting": lambda self: types.Sorting.blending() if blend else types.Sorting.opaque(),
        "to_textures": lambda self: [],
        "to_data": lambda self: self.color,
        "to_flags": lambda self: 0,
    })


def registry_scene(runner, flat_cls, mat=None, types=None, m3=None):
    """tests/test_routine_registry.py:55-71's scene: a green lit PBR plane,
    a red `flat_cls` cube above it, one shadowed light, orthographic.
    Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    pbr = runner.add_lit_material([0.1, 0.6, 0.1, 1.0])
    keep += [pbr, runner.plane(pbr, m3.rotation_x(-np.pi / 2) @ m3.scale(3.0))]
    flat = runner.renderer.add_material(flat_cls([0.9, 0.02, 0.02, 1.0]))
    keep += [flat, runner.cube(flat, m3.translation([0.0, 0.5, 0.0]) @ m3.scale(0.5))]
    runner.set_camera_data(types.Camera(
        projection=types.Orthographic(size=np.array([4.0, 4.0, 8.0], np.float32)),
        view=m3.look_at_lh([0.0, 1.5, -2.0], [0.0, 0.25, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def skybox_cube(runner, mat=None, types=None, m3=None):
    """An unlit cube in front of a 16x16 random RGBA8 skybox, wide
    perspective. Modules as in textured_planes. Returns the handles to
    keep; the last is the cube texture (its idx is the skybox slot)."""
    mat, types, m3 = _modules(mat, types, m3)
    m = runner.add_unlit_material([0.8, 0.5, 0.3, 1.0])
    keep = [m, runner.cube(m, m3.scale(0.4))]
    faces = (np.random.default_rng(5).random((6, 16, 16, 4)) * 255).astype(np.uint8)
    faces[..., 3] = 255
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=100.0, near=0.1),
        view=m3.look_at_lh([1.0, 0.7, -1.5], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep + [runner.renderer.add_texture_cube(types.Texture(
        label="sky", data=faces, format=types.TextureFormat.RGBA8_UNORM_SRGB, mip_count=types.MipmapCount.ONE,
    ))]


def sky_faces(rng, size: int) -> np.ndarray:
    """(6, size, size, 4) f32 linear cube faces: a vertical sky gradient
    (horizon to zenith, the +Y face zenith blue, -Y ground grey) plus noise."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size
    faces = np.empty((6, size, size, 4), np.float32)
    horizon = np.array([0.85, 0.8, 0.7], np.float32)
    zenith = np.array([0.15, 0.35, 0.8], np.float32)
    for f in range(6):
        if f == 2:
            base = np.broadcast_to(zenith, (size, size, 3))
        elif f == 3:
            base = np.broadcast_to(np.array([0.3, 0.28, 0.25], np.float32), (size, size, 3))
        else:
            up = 1.0 - t  # face rows run top (up) to bottom
            base = horizon[None, None] + (zenith - horizon)[None, None] * up[:, None, None]
        faces[f, ..., :3] = base + 0.05 * rng.standard_normal((size, size, 3)).astype(np.float32)
    faces[..., 3] = 1.0
    return np.clip(faces, 0.0, None)


def feature_city(runner, n_buildings=600, seed=7, sky_size=512, n_columns=64):
    """The representative bench city (build_city_scene(representative=True))
    with the frame's extension features, procedural and from `seed`:

    - a skybox: one 6 x sky_size^2 RGBA32F cube texture (sky_faces), to pass
      as `skybox_slot`;
    - n_columns skinned columns (the g = 8 column mesh: 486 vertices, 768
      triangles, 4 joints along its height), posed by pose_columns;
    - a registered unlit archetype ("SignMaterial") on 16 sign quads, a
      cutout routine ("CutoutSignMaterial", alpha from a uv checker, cutoff
      0.5) and a blend routine ("GlassSignMaterial") on 8 quads each, and 4
      magenta quads of an archetype with no routine ("HiddenSignMaterial"),
      which must not draw;
    - an "hdr" pass (an exposure scale of 1.1) and an "srgb" pass (a 64x64
      tint in the top-left corner of the target; it takes the image's first
      row, so a row band tints the same pixels) on runner.base_graph.

    Returns (handles to keep, dict with "sky" (the cube texture's handle),
    "skeletons", "passes" ((hdr fn, srgb fn)), "routines" and "classes"
    (the four sign material classes by archetype name))."""
    import torch

    from .routine.registry import MaterialRoutine, unlit_routine
    from .types import Object, StaticMeshKind, Texture, TextureFormat, MipmapCount
    from .utils import math as m3

    keep = build_city_scene(runner, n_buildings=n_buildings, seed=seed, representative=True)
    rng = np.random.default_rng(seed + 1000)
    r = runner.renderer
    sky = r.add_texture_cube(Texture(
        label="sky", data=sky_faces(rng, sky_size), format=TextureFormat.RGBA32_FLOAT, mip_count=MipmapCount.ONE,
    ))
    keep.append(sky)

    # Columns and signs float around the bench camera's sight line
    # ([40, 30, -60] -> [0, 5, 0]), in front of the city, as the storefront
    # panes do.
    cam, target = np.array([40.0, 30.0, -60.0]), np.array([0.0, 5.0, 0.0])
    col_mat = runner.add_lit_material([0.75, 0.72, 0.68, 1.0])
    keep.append(col_mat)
    placements = []
    for k in range(n_columns):
        p = cam + rng.uniform(0.25, 0.5) * (target - cam) + np.array([rng.uniform(-9.0, 9.0), -4.0, 0.0])
        h = rng.uniform(1.0, 2.5)
        placements.append((m3.translation(p) @ m3.scale([0.3, h, 0.3]), 0.0, 0.0))
    k2, skeletons = add_skinned_columns(runner, placements, col_mat, g=8)
    keep += k2
    pose_columns(runner, skeletons, 0.0)

    sign_cls = flat_material_class("SignMaterial")
    cut_cls = flat_material_class("CutoutSignMaterial")
    glass_cls = flat_material_class("GlassSignMaterial", blend=True)
    hidden_cls = flat_material_class("HiddenSignMaterial")  # no routine: must not draw

    def checker_alpha(pixels, mdata, mflags):
        u, v = pixels.uv0[:, 0], pixels.uv0[:, 1]
        return ((torch.floor(u * 4.0) + torch.floor(v * 4.0)) % 2.0).float()

    def glass_shade(pixels, mdata, mflags, dir_lights, point_lights, shadow_values, uniforms):
        return mdata[:, :4] * pixels.vcol

    routines = (
        unlit_routine(sign_cls),
        MaterialRoutine(cut_cls, shade=unlit_routine(cut_cls).shade, transparency="cutout", alpha=checker_alpha,
                        alpha_cutoff=0.5),
        MaterialRoutine(glass_cls, shade=glass_shade, transparency="blend"),
    )
    for rt in routines:
        runner.base_graph.register_routine(rt)
    from . import types

    quad = _quad_mesh(r, types, double_sided=True)
    keep.append(quad)
    for cls, n, color in ((sign_cls, 16, (0.9, 0.8, 0.1, 1.0)), (cut_cls, 8, (0.2, 0.9, 0.3, 1.0)),
                          (glass_cls, 8, (0.9, 0.2, 0.6, 0.45)), (hidden_cls, 4, (1.0, 0.0, 1.0, 1.0))):
        for _ in range(n):
            m = r.add_material(cls(list(color)))
            p = cam + rng.uniform(0.2, 0.45) * (target - cam) + np.array([rng.uniform(-7.0, 7.0), rng.uniform(-2.0, 3.0), 0.0])
            s = rng.uniform(0.6, 1.4)
            keep += [m, r.add_object(Object(
                mesh_kind=StaticMeshKind(quad), material=m,
                transform=m3.translation(p) @ m3.rotation_y(rng.uniform(-0.6, 0.6)) @ m3.scale(s),
            ))]

    def exposure(img, gbuf, uniforms):
        return img * 1.1

    def corner_tint(img, gbuf, uniforms, row0=0):
        # The target's rows 0-63: img's first row is target row row0 (a
        # row band's first row), so a banded frame tints the same pixels.
        out = img.clone()
        n = max(0, 64 - row0)
        out[:n, :64, :3] = (out[:n, :64, :3].float() * 0.5 + 100.0).to(img.dtype)
        return out

    runner.base_graph.register_pass(exposure, stage="hdr")
    runner.base_graph.register_pass(corner_tint, stage="srgb")
    classes = {c.__name__: c for c in (sign_cls, cut_cls, glass_cls, hidden_cls)}
    return keep, {
        "sky": sky, "skeletons": skeletons, "passes": (exposure, corner_tint), "routines": routines, "classes": classes,
    }


# ---------------------------------------------------------------------------
# The row bands' scenes (tests/test_multichip.py)
# ---------------------------------------------------------------------------


def shadow_cube(runner, mat=None, types=None, m3=None):
    """A lit cube on a lit plane under one shadowed light, orthographic
    (__graft_entry__._build_scene, the scene of tests/test_shadow.py).
    Modules as in textured_planes. Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    mat1 = runner.add_lit_material([0.25, 0.5, 0.75, 1.0])
    keep += [mat1, runner.plane(mat1, m3.rotation_x(-np.pi / 2))]
    mat2 = runner.add_lit_material([0.75, 0.5, 0.25, 1.0])
    keep += [mat2, runner.cube(mat2, m3.translation([0.25, 0.25, -0.25]) @ m3.scale(0.25))]
    runner.set_camera_data(types.Camera(
        projection=types.Orthographic(size=np.array([2.5, 2.5, 5.0], np.float32)),
        view=m3.look_at_lh([0.0, 1.0, -1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def band_features(runner, mat=None, types=None, m3=None):
    """A textured (mip-mapped) opaque plane, a cutout quad with alternate
    rows of its texture transparent and a blended glass pane under one
    shadowed light, orthographic (test_multichip.py's
    test_tiled_textured_cutout_blend_bit_exact). Modules as in
    textured_planes. Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    r = runner.renderer
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    rng = np.random.default_rng(11)
    tex_data = (rng.random((32, 32, 4)) * 255).astype(np.uint8)
    tex_data[..., 3] = 255
    alb = r.add_texture_2d(types.Texture(
        label="t", data=tex_data, format=types.TextureFormat.RGBA8_UNORM_SRGB, mip_count=types.MipmapCount.MAXIMUM,
    ))
    mat_tex = r.add_material(mat.PbrMaterial(albedo=mat.AlbedoComponent.new_texture(alb)))
    keep += [alb, mat_tex, runner.plane(mat_tex, m3.rotation_x(-np.pi / 2))]
    cut_data = (rng.random((32, 32, 4)) * 255).astype(np.uint8)
    cut_data[..., 3] = np.where(np.arange(32)[:, None] % 2 == 0, 255, 0).astype(np.uint8)
    ctex = r.add_texture_2d(types.Texture(
        label="c", data=cut_data, format=types.TextureFormat.RGBA8_UNORM_SRGB, mip_count=types.MipmapCount.ONE,
    ))
    mat_cut = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_texture(ctex), transparency=mat.Transparency.cutout_at(0.5),
    ))
    quad_v = np.array([[-1, 1, 0], [1, 1, 0], [1, -1, 0], [-1, -1, 0]], np.float32)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quad = r.add_mesh(
        types.MeshBuilder(quad_v, types.Handedness.LEFT)
        .with_vertex_uv0(quad_uv)
        .with_indices(np.array([0, 1, 2, 2, 3, 0], np.uint32))
        .build()
    )
    keep += [ctex, mat_cut, quad, r.add_object(types.Object(
        mesh_kind=types.StaticMeshKind(quad), material=mat_cut,
        transform=m3.translation([0.0, 0.5, -0.3]) @ m3.scale(0.4),
    ))]
    mat_glass = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_value(np.array([0.4, 0.7, 0.9, 0.4], np.float32)),
        transparency=mat.Transparency.blend(),
    ))
    keep += [mat_glass, r.add_object(types.Object(
        mesh_kind=types.StaticMeshKind(quad), material=mat_glass,
        transform=m3.translation([0.2, 0.4, -0.5]) @ m3.scale(0.5),
    ))]
    runner.set_camera_data(types.Camera(
        projection=types.Orthographic(size=np.array([2.5, 2.5, 5.0], np.float32)),
        view=m3.look_at_lh([0.0, 1.0, -1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def mipmapped_floor(runner, mat=None, types=None, m3=None):
    """A mip-mapped textured ground plane receding under perspective, so
    mip selection reads the uv derivatives across band boundaries
    (test_multichip.py's _mipmapped_perspective_scene). Modules as in
    textured_planes. Returns the handles to keep."""
    mat, types, m3 = _modules(mat, types, m3)
    r = runner.renderer
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    rng = np.random.default_rng(7)
    tex_data = (rng.random((64, 64, 4)) * 255).astype(np.uint8)
    tex_data[..., 3] = 255
    alb = r.add_texture_2d(types.Texture(
        label="ground", data=tex_data, format=types.TextureFormat.RGBA8_UNORM_SRGB,
        mip_count=types.MipmapCount.MAXIMUM,
    ))
    mat_g = r.add_material(mat.PbrMaterial(albedo=mat.AlbedoComponent.new_texture(alb)))
    keep += [alb, mat_g, runner.plane(mat_g, m3.rotation_x(-np.pi / 2) @ m3.scale(4.0))]
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=60.0, near=0.1),
        view=m3.look_at_lh([1.5, 1.2, -2.5], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep


def rich_scene(runner, mat=None, types=None, m3=None):
    """__graft_entry__._build_rich_scene (__graft_entry__.py:40-126): a
    textured ground plane, a lit cube casting a shadow, an alpha-cutout quad,
    a blended glass pane and a 6-face gradient skybox under one shadowed
    light, perspective; every path of the frame in one small scene, from the
    same seed and in the same order. Modules as in textured_planes. Returns
    the handles to keep; the last is the cube texture (its idx is the
    skybox slot)."""
    mat, types, m3 = _modules(mat, types, m3)
    r = runner.renderer
    rng = np.random.default_rng(5)
    keep = [runner.add_directional_light(np.array([-1.0, -1.0, 1.0], np.float32))]
    tex_data = (rng.random((64, 64, 4)) * 255).astype(np.uint8)
    tex_data[..., 3] = 255
    alb = r.add_texture_2d(types.Texture(
        label="ground", data=tex_data, format=types.TextureFormat.RGBA8_UNORM_SRGB,
        mip_count=types.MipmapCount.MAXIMUM,
    ))
    mat_ground = r.add_material(mat.PbrMaterial(albedo=mat.AlbedoComponent.new_texture(alb)))
    keep += [alb, mat_ground, runner.plane(mat_ground, m3.rotation_x(-np.pi / 2) @ m3.scale(4.0))]
    mat_cube = runner.add_lit_material([0.75, 0.5, 0.25, 1.0])
    keep += [mat_cube, runner.cube(mat_cube, m3.translation([0.5, 0.4, -0.5]) @ m3.scale(0.4))]
    cut = (rng.random((32, 32, 4)) * 255).astype(np.uint8)
    cut[..., 3] = np.where(np.arange(32)[:, None] % 2 == 0, 255, 0).astype(np.uint8)
    ctex = r.add_texture_2d(types.Texture(
        label="cut", data=cut, format=types.TextureFormat.RGBA8_UNORM_SRGB, mip_count=types.MipmapCount.ONE,
    ))
    mat_cut = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_texture(ctex), transparency=mat.Transparency.cutout_at(0.5),
    ))
    quad = _quad_mesh(r, types)
    keep += [ctex, mat_cut, quad, r.add_object(types.Object(
        mesh_kind=types.StaticMeshKind(quad), material=mat_cut,
        transform=m3.translation([-0.7, 0.6, -0.2]) @ m3.scale(0.5),
    ))]
    mat_glass = r.add_material(mat.PbrMaterial(
        albedo=mat.AlbedoComponent.new_value(np.array([0.4, 0.7, 0.9, 0.4], np.float32)),
        transparency=mat.Transparency.blend(),
    ))
    keep += [mat_glass, r.add_object(types.Object(
        mesh_kind=types.StaticMeshKind(quad), material=mat_glass,
        transform=m3.translation([0.1, 0.5, -1.0]) @ m3.scale(0.6),
    ))]
    faces = np.zeros((6, 32, 32, 4), np.uint8)
    for f in range(6):
        faces[f, ..., f % 3] = np.linspace(40, 220, 32, dtype=np.uint8)[None, :]
        faces[f, ..., 3] = 255
    sky = r.add_texture_cube(types.Texture(
        label="sky", data=faces, format=types.TextureFormat.RGBA8_UNORM_SRGB, mip_count=types.MipmapCount.ONE,
    ))
    runner.set_camera_data(types.Camera(
        projection=types.Perspective(vfov=60.0, near=0.1),
        view=m3.look_at_lh([1.5, 1.2, -2.5], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0]),
    ))
    return keep + [sky]
