// Native host-side hot loops.
//
// The reference gets these for free from Rust (rend3-types mesh normal /
// tangent generation: lib.rs:662-702, 784-837; range allocation; triangle
// batching). Python loops are 100-1000x slower at scene-build time, so the
// per-index accumulation loops live here, exposed via a C ABI consumed with
// ctypes (rend3_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <vector>

extern "C" {

// Area-weighted smooth normals. left_handed: edge1 x edge2, else reversed.
// positions: (n_verts, 3) f32; indices: (n_idx,) u32; normals out (n_verts, 3).
void calculate_normals(const float* positions, int64_t n_verts,
                       const uint32_t* indices, int64_t n_idx,
                       int left_handed, float* normals) {
    std::memset(normals, 0, sizeof(float) * 3 * n_verts);
    for (int64_t t = 0; t + 2 < n_idx; t += 3) {
        const uint32_t i0 = indices[t], i1 = indices[t + 1], i2 = indices[t + 2];
        const float* p0 = positions + 3 * i0;
        const float* p1 = positions + 3 * i1;
        const float* p2 = positions + 3 * i2;
        float e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
        float e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
        float n[3];
        if (left_handed) {
            n[0] = e1[1] * e2[2] - e1[2] * e2[1];
            n[1] = e1[2] * e2[0] - e1[0] * e2[2];
            n[2] = e1[0] * e2[1] - e1[1] * e2[0];
        } else {
            n[0] = e2[1] * e1[2] - e2[2] * e1[1];
            n[1] = e2[2] * e1[0] - e2[0] * e1[2];
            n[2] = e2[0] * e1[1] - e2[1] * e1[0];
        }
        for (int k = 0; k < 3; ++k) {
            normals[3 * i0 + k] += n[k];
            normals[3 * i1 + k] += n[k];
            normals[3 * i2 + k] += n[k];
        }
    }
    for (int64_t v = 0; v < n_verts; ++v) {
        float* n = normals + 3 * v;
        float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (len > 0.f) {
            n[0] /= len; n[1] /= len; n[2] /= len;
        } else {
            n[0] = n[1] = n[2] = 0.f;
        }
    }
}

// UV-space tangents, Gram-Schmidt vs normals (reference exact formula incl.
// the quirk that r scales only the second term: lib.rs:826).
void calculate_tangents(const float* positions, const float* normals,
                        const float* uvs, int64_t n_verts,
                        const uint32_t* indices, int64_t n_idx,
                        float* tangents) {
    std::memset(tangents, 0, sizeof(float) * 3 * n_verts);
    for (int64_t t = 0; t + 2 < n_idx; t += 3) {
        const uint32_t i0 = indices[t], i1 = indices[t + 1], i2 = indices[t + 2];
        const float* p0 = positions + 3 * i0;
        const float* p1 = positions + 3 * i1;
        const float* p2 = positions + 3 * i2;
        const float* t0 = uvs + 2 * i0;
        const float* t1 = uvs + 2 * i1;
        const float* t2 = uvs + 2 * i2;
        float e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
        float e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
        float uv1[2] = {t1[0] - t0[0], t1[1] - t0[1]};
        float uv2[2] = {t2[0] - t0[0], t2[1] - t0[1]};
        float denom = uv1[0] * uv2[1] - uv1[1] * uv2[0];
        float r = denom != 0.f ? 1.f / denom : 0.f;
        float tan[3];
        for (int k = 0; k < 3; ++k)
            tan[k] = e1[k] * uv2[1] - (e2[k] * uv1[1]) * r;
        if (!std::isfinite(tan[0]) || !std::isfinite(tan[1]) || !std::isfinite(tan[2]))
            continue;
        for (int k = 0; k < 3; ++k) {
            tangents[3 * i0 + k] += tan[k];
            tangents[3 * i1 + k] += tan[k];
            tangents[3 * i2 + k] += tan[k];
        }
    }
    for (int64_t v = 0; v < n_verts; ++v) {
        const float* n = normals + 3 * v;
        float* tn = tangents + 3 * v;
        float d = n[0] * tn[0] + n[1] * tn[1] + n[2] * tn[2];
        float t3[3] = {tn[0] - n[0] * d, tn[1] - n[1] * d, tn[2] - n[2] * d};
        float len = std::sqrt(t3[0] * t3[0] + t3[1] * t3[1] + t3[2] * t3[2]);
        if (len > 0.f) {
            tn[0] = t3[0] / len; tn[1] = t3[1] / len; tn[2] = t3[2] / len;
        } else {
            tn[0] = tn[1] = tn[2] = 0.f;
        }
    }
}

// ---------------------------------------------------------------------------
// Range allocator (first-fit, coalescing) — reference: range-alloc crate use
// in rend3/src/managers/mesh.rs. Handle-based C ABI.
// ---------------------------------------------------------------------------

struct RangeAlloc {
    std::map<int64_t, int64_t> free_by_start;  // start -> len
    int64_t size;
};

void* range_alloc_new(int64_t size) {
    RangeAlloc* ra = new RangeAlloc();
    ra->size = size;
    if (size > 0) ra->free_by_start[0] = size;
    return ra;
}

void range_alloc_free_handle(void* h) { delete static_cast<RangeAlloc*>(h); }

int64_t range_alloc_allocate(void* h, int64_t count) {
    RangeAlloc* ra = static_cast<RangeAlloc*>(h);
    if (count == 0) return 0;
    for (auto it = ra->free_by_start.begin(); it != ra->free_by_start.end(); ++it) {
        if (it->second >= count) {
            int64_t start = it->first;
            int64_t len = it->second;
            ra->free_by_start.erase(it);
            if (len > count) ra->free_by_start[start + count] = len - count;
            return start;
        }
    }
    return -1;
}

void range_alloc_release(void* h, int64_t start, int64_t count) {
    RangeAlloc* ra = static_cast<RangeAlloc*>(h);
    if (count == 0) return;
    auto next = ra->free_by_start.lower_bound(start);
    // coalesce with previous
    if (next != ra->free_by_start.begin()) {
        auto prev = std::prev(next);
        if (prev->first + prev->second == start) {
            start = prev->first;
            count += prev->second;
            ra->free_by_start.erase(prev);
        }
    }
    // coalesce with next
    if (next != ra->free_by_start.end() && start + count == next->first) {
        count += next->second;
        ra->free_by_start.erase(next);
    }
    ra->free_by_start[start] = count;
}

void range_alloc_grow(void* h, int64_t new_size) {
    RangeAlloc* ra = static_cast<RangeAlloc*>(h);
    if (new_size <= ra->size) return;
    range_alloc_release(h, ra->size, new_size - ra->size);
    ra->size = new_size;
}

int64_t range_alloc_used(void* h) {
    RangeAlloc* ra = static_cast<RangeAlloc*>(h);
    int64_t free_total = 0;
    for (auto& kv : ra->free_by_start) free_total += kv.second;
    return ra->size - free_total;
}

// ---------------------------------------------------------------------------
// Triangle-table assembly: concatenate per-object mesh-local triangles with
// object ids (the host loop behind ObjectManager::build_tri_tables).
// objects: (n_objects, 3) i64 rows [index_start, index_count, object_id];
// indices: the index arena; out: (total_tris, 4) i32 [v0 v1 v2 obj].
// Returns number of triangles written.
int64_t build_tri_table(const int64_t* objects, int64_t n_objects,
                        const int32_t* indices, int64_t /*n_idx*/,
                        int32_t* out, int64_t out_cap_tris) {
    int64_t w = 0;
    for (int64_t o = 0; o < n_objects; ++o) {
        const int64_t start = objects[3 * o];
        const int64_t count = objects[3 * o + 1];
        const int32_t obj = static_cast<int32_t>(objects[3 * o + 2]);
        for (int64_t i = start; i + 2 < start + count; i += 3) {
            if (w >= out_cap_tris) return w;
            out[4 * w] = indices[i];
            out[4 * w + 1] = indices[i + 1];
            out[4 * w + 2] = indices[i + 2];
            out[4 * w + 3] = obj;
            ++w;
        }
    }
    return w;
}

}  // extern "C"
