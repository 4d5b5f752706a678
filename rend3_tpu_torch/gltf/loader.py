"""glTF 2.0 scene loader (counterpart of rend3-gltf, hand-rolled: no
third-party gltf dependency; port of rend3_tpu/gltf/loader.py, host numpy
that sends instructions to the port's Renderer).

Reference: rend3-gltf/src/lib.rs — `load_gltf` = load data (meshes,
materials+textures, skins, animations) + `instance_loaded_scene` (flat node
array in topological order; one Object per primitive; animated primitives get
per-primitive Skeletons sharing joints; KHR_lights_punctual directional
lights). The root transform is scale(s, s, ±s) with Z negated for left-handed
renderers (lib.rs:363-369), which converts glTF's right-handed space.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.renderer import Renderer
from ..routine.pbr.material import (
    AlbedoComponent,
    AoMRTextures,
    MaterialComponent,
    NormalTexture,
    PbrMaterial,
    Transparency,
)
from ..types import (
    AnimatedMeshKind,
    DirectionalLight,
    Handedness,
    MeshBuilder,
    MipmapCount,
    Object,
    Skeleton,
    StaticMeshKind,
    Texture,
    TextureFormat,
)

__all__ = ["GltfLoadSettings", "LoadedGltfScene", "GltfSceneInstance", "load_gltf", "load_gltf_file"]

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class GltfLoadSettings:
    """reference: rend3-gltf/src/lib.rs:287-310."""

    scale: float = 1.0
    directional_light_shadow_distance: float = 100.0
    directional_light_resolution: int = 2048
    normal_y_down: bool = False
    enable_directional: bool = True


@dataclass
class LoadedGltfScene:
    meshes: List[List[Tuple[object, Optional[int]]]] = field(default_factory=list)
    # meshes[i] = list of (mesh_handle, material_index) per primitive
    materials: List[object] = field(default_factory=list)
    default_material: object = None
    images: List[object] = field(default_factory=list)
    skins: List[dict] = field(default_factory=list)
    animations: List[dict] = field(default_factory=list)


@dataclass
class GltfSceneInstance:
    objects: List[object] = field(default_factory=list)
    skeletons: Dict[int, List[object]] = field(default_factory=dict)  # node -> skeleton handles
    node_skins: Dict[int, int] = field(default_factory=dict)  # node -> skin index (armature.skin_index)
    objects_by_node: Dict[int, List[object]] = field(default_factory=dict)  # node -> object handles
    lights: List[object] = field(default_factory=list)
    node_transforms: List[np.ndarray] = field(default_factory=list)
    node_parents: List[Optional[int]] = field(default_factory=list)
    node_locals: List[np.ndarray] = field(default_factory=list)
    topo_order: List[int] = field(default_factory=list)


class _GltfFile:
    def __init__(self, data: bytes, base_dir: Optional[str] = None):
        self.base_dir = base_dir
        if data[:4] == b"glTF":
            # GLB container
            _, version, _ = struct.unpack("<III", data[:12])
            offset = 12
            self.json: dict = {}
            self.blob: Optional[bytes] = None
            while offset < len(data):
                clen, ctype = struct.unpack("<II", data[offset : offset + 8])
                chunk = data[offset + 8 : offset + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:  # BIN
                    self.blob = chunk
                offset += 8 + clen
        else:
            self.json = json.loads(data)
            self.blob = None
        self.buffers = [self._load_buffer(b) for b in self.json.get("buffers", [])]

    def _load_buffer(self, buf: dict) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            return self.blob or b""
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        if self.base_dir is None:
            raise FileNotFoundError(f"external buffer {uri} with no base dir")
        from urllib.parse import unquote

        with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
            return f.read()

    def accessor(self, idx: int) -> np.ndarray:
        a = self.json["accessors"][idx]
        count = a["count"]
        n = _TYPE_COUNTS[a["type"]]
        dt = _COMPONENT_DTYPES[a["componentType"]]
        itemsize = np.dtype(dt).itemsize * n
        if "bufferView" in a:
            bv = self.json["bufferViews"][a["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            if stride == itemsize:
                arr = np.frombuffer(buf, dtype=dt, count=count * n, offset=start).reshape(count, n)
            else:
                raw = np.frombuffer(buf, dtype=np.uint8)
                idxs = start + stride * np.arange(count)[:, None] + np.arange(itemsize)[None, :]
                arr = raw[idxs].copy().view(dt).reshape(count, n)
        else:
            arr = np.zeros((count, n), dtype=dt)
        if a.get("normalized"):
            info = np.iinfo(dt)
            arr = arr.astype(np.float32) / float(info.max)
        return arr

    def image_bytes(self, idx: int) -> bytes:
        img = self.json["images"][idx]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                return base64.b64decode(uri.split(",", 1)[1])
            from urllib.parse import unquote

            with open(os.path.join(self.base_dir, unquote(uri)), "rb") as f:
                return f.read()
        bv = self.json["bufferViews"][img["bufferView"]]
        buf = self.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0)
        return buf[start : start + bv["byteLength"]]


def _node_local_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major in gltf
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)  # xyzw
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def _load_image_texture(renderer: Renderer, file: _GltfFile, gltf_tex: dict, srgb: bool):
    src = gltf_tex["source"]
    data = file.image_bytes(src)
    # ktx2/dds containers (reference: rend3-gltf/src/lib.rs:1185-1627) are
    # parsed + BCn-decoded on the host; everything else goes through PIL.
    if data[:12] == b"\xabKTX 20\xbb\r\n\x1a\n":
        from .compressed import decode_ktx2

        arr, fmt_srgb = decode_ktx2(bytes(data))
        srgb = srgb or fmt_srgb
    elif data[:4] == b"DDS ":
        from .compressed import decode_dds

        arr, fmt_srgb = decode_dds(bytes(data))
        srgb = srgb or fmt_srgb
    else:
        from PIL import Image

        pil = Image.open(io.BytesIO(data)).convert("RGBA")
        arr = np.asarray(pil)
    fmt = TextureFormat.RGBA8_UNORM_SRGB if srgb else TextureFormat.RGBA8_UNORM
    return renderer.add_texture_2d(
        Texture(label=f"gltf image {src}", data=arr, format=fmt, mip_count=MipmapCount.MAXIMUM)
    )


def load_gltf_data(renderer: Renderer, file: _GltfFile, settings: GltfLoadSettings) -> LoadedGltfScene:
    loaded = LoadedGltfScene()
    loaded.default_material = renderer.add_material(
        PbrMaterial(albedo=AlbedoComponent.new_value([1, 1, 1, 1]))
    )

    # -- textures (lazily cached by (texture index, srgb)) --
    tex_cache: Dict[Tuple[int, bool], object] = {}

    def get_texture(tex_index: Optional[int], srgb: bool):
        if tex_index is None:
            return None
        key = (tex_index, srgb)
        if key not in tex_cache:
            gtex = file.json["textures"][tex_index]
            handle = _load_image_texture(renderer, file, gtex, srgb)
            tex_cache[key] = handle
            loaded.images.append(handle)
        return tex_cache[key]

    # -- materials (pbrMetallicRoughness mapping, lib.rs load_materials...) --
    for mat in file.json.get("materials", []):
        pmr = mat.get("pbrMetallicRoughness", {})
        base_tex = pmr.get("baseColorTexture")
        base_color = np.asarray(pmr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        albedo = AlbedoComponent(
            value=base_color,
            texture=get_texture(base_tex["index"] if base_tex else None, True),
        )
        # AoMR mapping (reference lib.rs:904-921): Combined only when the
        # occlusion texture IS the metallicRoughness texture; otherwise
        # SwizzledSplit with the MR texture + a separate (optional) AO
        # texture. (The reference's Split arm requires a <3-component AO
        # format; we decode all images to RGBA, so it never applies.)
        mr_tex = pmr.get("metallicRoughnessTexture")
        occ = mat.get("occlusionTexture")
        if mr_tex is not None and occ is not None and occ["index"] == mr_tex["index"]:
            aomr = AoMRTextures(
                mode="combined",
                aomr_texture=get_texture(mr_tex["index"], False),
            )
        elif mr_tex is not None or occ is not None:
            aomr = AoMRTextures(
                mode="swizzled_split",
                aomr_texture=get_texture(mr_tex["index"] if mr_tex else None, False),
                ao_texture=get_texture(occ["index"] if occ else None, False),
            )
        else:
            aomr = AoMRTextures(mode="none")
        nrm = mat.get("normalTexture")
        normal = NormalTexture(
            texture=get_texture(nrm["index"] if nrm else None, False),
            y_down=settings.normal_y_down,
        )
        em_tex = mat.get("emissiveTexture")
        emissive = MaterialComponent(
            value=np.asarray(mat.get("emissiveFactor", [0, 0, 0]), np.float32),
            texture=get_texture(em_tex["index"] if em_tex else None, True),
        )
        alpha_mode = mat.get("alphaMode", "OPAQUE")
        if alpha_mode == "MASK":
            transparency = Transparency.cutout_at(mat.get("alphaCutoff", 0.5))
        elif alpha_mode == "BLEND":
            transparency = Transparency.blend()
        else:
            transparency = Transparency.opaque()
        loaded.materials.append(
            renderer.add_material(
                PbrMaterial(
                    albedo=albedo,
                    transparency=transparency,
                    normal=normal,
                    aomr_textures=aomr,
                    metallic_factor=pmr.get("metallicFactor", 1.0),
                    roughness_factor=pmr.get("roughnessFactor", 1.0),
                    emissive=emissive,
                    unlit="KHR_materials_unlit" in mat.get("extensions", {}),
                )
            )
        )

    # -- meshes --
    for mesh in file.json.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            positions = file.accessor(attrs["POSITION"]).astype(np.float32)
            builder = MeshBuilder(positions, renderer.handedness)
            # reference flips winding for left-handed renderers (the root
            # Z-flip mirrors parity; the index flip restores it, lib.rs:632).
            if renderer.handedness == Handedness.LEFT:
                builder = builder.with_flip_winding_order()
            if "indices" in prim:
                builder = builder.with_indices(file.accessor(prim["indices"]).reshape(-1).astype(np.uint32))
            if "NORMAL" in attrs:
                builder = builder.with_vertex_normals(file.accessor(attrs["NORMAL"]).astype(np.float32))
            if "TANGENT" in attrs:
                builder = builder.with_vertex_tangents(file.accessor(attrs["TANGENT"])[:, :3].astype(np.float32))
            if "TEXCOORD_0" in attrs:
                builder = builder.with_vertex_uv0(file.accessor(attrs["TEXCOORD_0"]).astype(np.float32))
            if "TEXCOORD_1" in attrs:
                builder = builder.with_vertex_uv1(file.accessor(attrs["TEXCOORD_1"]).astype(np.float32))
            if "COLOR_0" in attrs:
                c = file.accessor(attrs["COLOR_0"]).astype(np.float32)
                if c.shape[1] == 3:
                    c = np.concatenate([c, np.ones((len(c), 1), np.float32)], axis=1)
                builder = builder.with_vertex_colors(c)
            if "JOINTS_0" in attrs:
                builder = builder.with_vertex_joint_indices(file.accessor(attrs["JOINTS_0"]).astype(np.uint16))
            if "WEIGHTS_0" in attrs:
                builder = builder.with_vertex_joint_weights(file.accessor(attrs["WEIGHTS_0"]).astype(np.float32))
            handle = renderer.add_mesh(builder.build())
            prims.append((handle, prim.get("material")))
        loaded.meshes.append(prims)

    # -- skins --
    for skin in file.json.get("skins", []):
        ibm = (
            file.accessor(skin["inverseBindMatrices"]).reshape(-1, 4, 4).transpose(0, 2, 1).astype(np.float32)
            if "inverseBindMatrices" in skin
            else np.tile(np.eye(4, dtype=np.float32), (len(skin["joints"]), 1, 1))
        )
        loaded.skins.append({"joints": skin["joints"], "inverse_bind_matrices": ibm})

    # -- animations --
    for anim in file.json.get("animations", []):
        channels = []
        for ch in anim.get("channels", []):
            sampler = anim["samplers"][ch["sampler"]]
            times = file.accessor(sampler["input"]).reshape(-1).astype(np.float32)
            values = file.accessor(sampler["output"]).astype(np.float32)
            channels.append(
                {
                    "node": ch["target"]["node"],
                    "path": ch["target"]["path"],
                    "times": times,
                    "values": values,
                    "interpolation": sampler.get("interpolation", "LINEAR"),
                }
            )
        loaded.animations.append({"name": anim.get("name", ""), "channels": channels})

    return loaded


def instance_loaded_scene(
    renderer: Renderer, file: _GltfFile, loaded: LoadedGltfScene, settings: GltfLoadSettings
) -> GltfSceneInstance:
    inst = GltfSceneInstance()
    nodes = file.json.get("nodes", [])
    n = len(nodes)

    parent = [None] * n
    for i, node in enumerate(nodes):
        for c in node.get("children", []):
            parent[c] = i

    s = settings.scale
    zs = -s if renderer.handedness == Handedness.LEFT else s
    root = np.diag(np.array([s, s, zs, 1.0], np.float32))

    # topological order (parents first)
    order: List[int] = []
    visited = [False] * n

    def visit(i):
        if visited[i]:
            return
        if parent[i] is not None:
            visit(parent[i])
        visited[i] = True
        order.append(i)

    for i in range(n):
        visit(i)

    locals_ = [_node_local_transform(nodes[i]) for i in range(n)]
    world = [None] * n
    for i in order:
        p = root if parent[i] is None else world[parent[i]]
        world[i] = (p @ locals_[i]).astype(np.float32)

    inst.node_transforms = world
    inst.node_parents = parent
    inst.node_locals = locals_
    inst.topo_order = order

    ext_lights = file.json.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])

    for i in order:
        node = nodes[i]
        if "mesh" in node:
            prims = loaded.meshes[node["mesh"]]
            skin_idx = node.get("skin")
            for mesh_handle, mat_idx in prims:
                material = (
                    loaded.materials[mat_idx] if mat_idx is not None else loaded.default_material
                )
                if skin_idx is not None:
                    skin = loaded.skins[skin_idx]
                    # reference convention (rend3-gltf lib.rs:438-441): rest
                    # pose = identity joint matrices (inv_bind * bind = I);
                    # posing composes armature-relative joint globals x IBMs.
                    jm = np.tile(np.eye(4, dtype=np.float32), (len(skin["joints"]), 1, 1))
                    sk_handle = renderer.add_skeleton(Skeleton(mesh=mesh_handle, joint_matrices=jm))
                    inst.skeletons.setdefault(i, []).append(sk_handle)
                    inst.node_skins[i] = skin_idx
                    obj = Object(
                        mesh_kind=AnimatedMeshKind(sk_handle), material=material, transform=world[i]
                    )
                else:
                    obj = Object(
                        mesh_kind=StaticMeshKind(mesh_handle), material=material, transform=world[i]
                    )
                handle = renderer.add_object(obj)
                inst.objects.append(handle)
                inst.objects_by_node.setdefault(i, []).append(handle)
        lt = node.get("extensions", {}).get("KHR_lights_punctual")
        if lt is not None and settings.enable_directional:
            light = ext_lights[lt["light"]]
            if light.get("type") == "directional":
                direction = (world[i] @ np.array([0, 0, -1, 0], np.float32))[:3]
                nl = np.linalg.norm(direction)
                direction = direction / (nl if nl else 1.0)
                inst.lights.append(
                    renderer.add_directional_light(
                        DirectionalLight(
                            color=np.asarray(light.get("color", [1, 1, 1]), np.float32),
                            intensity=light.get("intensity", 1.0),
                            direction=direction,
                            distance=settings.directional_light_shadow_distance,
                            resolution=settings.directional_light_resolution,
                        )
                    )
                )

    return inst


def load_gltf(
    renderer: Renderer,
    data: bytes,
    settings: Optional[GltfLoadSettings] = None,
    base_dir: Optional[str] = None,
):
    """reference: rend3-gltf/src/lib.rs:335 load_gltf."""
    settings = settings or GltfLoadSettings()
    file = _GltfFile(data, base_dir)
    loaded = load_gltf_data(renderer, file, settings)
    if len(file.json.get("scenes", [])) != 1:
        raise ValueError("only single-scene gltf files are supported")
    instance = instance_loaded_scene(renderer, file, loaded, settings)
    return loaded, instance, file


def load_gltf_file(renderer: Renderer, path: str, settings: Optional[GltfLoadSettings] = None):
    with open(path, "rb") as f:
        data = f.read()
    return load_gltf(renderer, data, settings, base_dir=os.path.dirname(os.path.abspath(path)))
