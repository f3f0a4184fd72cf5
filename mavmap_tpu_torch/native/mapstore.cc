// Native map-store core: track bookkeeping for the reconstruction state.
//
// Copy of mavmap_tpu/native/mapstore.cc for mavmap_tpu_torch, with one
// entry added (ms_load_tracks, a checkpoint's tracks restored under their
// own point3D ids). C++ counterpart of reference
// src/fm/feature_management.{h,cc} (FeatureManager). The semantics mirror
// the reference exactly (and the Python MapStore in fm/map_store.py, which
// doubles as the executable specification):
//   - add_correspondence creates / extends / merges tracks, keeping the
//     LONGER track on merge (feature_management.cc:107-226);
//   - at most one observation per image per track — duplicates dropped
//     (feature_management.h:96-110);
//   - ids are monotonically allocated ints, never reused.
//
// Exposed as a C ABI for ctypes, so g++ alone builds it.

#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

struct Track {
  std::vector<int64_t> obs;          // point2D ids
  std::unordered_set<int32_t> imgs;  // images observing this track
};

struct MapStoreCore {
  // point2D tables
  std::vector<int32_t> p2d_image;
  std::vector<int64_t> p2d_point3D;  // -1 = none
  // point3D tables
  std::vector<uint8_t> p3d_valid;
  std::vector<uint8_t> p3d_tri;
  std::vector<int32_t> p3d_track_len;
  std::vector<Track> tracks;

  int64_t new_point3D() {
    p3d_valid.push_back(1);
    p3d_tri.push_back(0);
    p3d_track_len.push_back(0);
    tracks.emplace_back();
    return static_cast<int64_t>(tracks.size()) - 1;
  }

  bool attach(int64_t pid, int64_t p2d) {
    Track& t = tracks[pid];
    int32_t img = p2d_image[p2d];
    if (t.imgs.count(img)) return false;
    t.obs.push_back(p2d);
    t.imgs.insert(img);
    p2d_point3D[p2d] = pid;
    p3d_track_len[pid] = static_cast<int32_t>(t.obs.size());
    return true;
  }
};

}  // namespace

extern "C" {

void* ms_create() { return new MapStoreCore(); }

void ms_destroy(void* h) { delete static_cast<MapStoreCore*>(h); }

// Register an image with n 2-D points; returns the first point2D id.
int64_t ms_add_image(void* h, int32_t image_id, int64_t n) {
  auto* m = static_cast<MapStoreCore*>(h);
  int64_t start = static_cast<int64_t>(m->p2d_image.size());
  m->p2d_image.insert(m->p2d_image.end(), n, image_id);
  m->p2d_point3D.insert(m->p2d_point3D.end(), n, -1);
  return start;
}

int64_t ms_num_points2D(void* h) {
  return static_cast<int64_t>(static_cast<MapStoreCore*>(h)->p2d_image.size());
}

int64_t ms_num_points3D(void* h) {
  auto* m = static_cast<MapStoreCore*>(h);
  int64_t n = 0;
  for (uint8_t v : m->p3d_valid) n += v;
  return n;
}

int64_t ms_capacity_points3D(void* h) {
  return static_cast<int64_t>(static_cast<MapStoreCore*>(h)->tracks.size());
}

// Core op — returns the surviving point3D id, or -1 for out-of-range
// point2D ids (a ctypes caller bug must surface as a visible error, not
// as a silent heap write through p2d_point3D[-1]).
int64_t ms_add_correspondence(void* h, int64_t a, int64_t b) {
  auto* m = static_cast<MapStoreCore*>(h);
  const int64_t n2d = static_cast<int64_t>(m->p2d_point3D.size());
  if (a < 0 || b < 0 || a >= n2d || b >= n2d) return -1;
  int64_t ta = m->p2d_point3D[a];
  int64_t tb = m->p2d_point3D[b];

  if (ta < 0 && tb < 0) {
    int64_t pid = m->new_point3D();
    m->attach(pid, a);
    m->attach(pid, b);
    return pid;
  }
  if (ta >= 0 && tb < 0) {
    m->attach(ta, b);
    return ta;
  }
  if (tb >= 0 && ta < 0) {
    m->attach(tb, a);
    return tb;
  }
  if (ta == tb) return ta;

  // Merge, keeping the longer track.
  int64_t keep = ta, drop = tb;
  if (m->p3d_track_len[tb] > m->p3d_track_len[ta]) {
    keep = tb;
    drop = ta;
  }
  for (int64_t p2d : m->tracks[drop].obs) {
    if (!m->attach(keep, p2d)) {
      m->p2d_point3D[p2d] = -1;  // duplicate image: drop observation
    }
  }
  m->tracks[drop] = Track();
  m->p3d_valid[drop] = 0;
  m->p3d_tri[drop] = 0;
  m->p3d_track_len[drop] = 0;
  return keep;
}

// All pid/p2d-indexed entry points bounds-check: ctypes callers feeding a
// stale or negative id must get a no-op / sentinel, never an out-of-range
// heap access (an OOB WRITE here corrupts allocator state and surfaces as
// a segfault far away).
static bool pid_ok(MapStoreCore* m, int64_t pid) {
  return pid >= 0 && pid < static_cast<int64_t>(m->tracks.size());
}

void ms_set_tri(void* h, int64_t pid, uint8_t tri) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (!pid_ok(m, pid)) return;
  m->p3d_tri[pid] = tri;
}

uint8_t ms_get_tri(void* h, int64_t pid) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (!pid_ok(m, pid)) return 0;
  return m->p3d_tri[pid];
}

uint8_t ms_get_valid(void* h, int64_t pid) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (!pid_ok(m, pid)) return 0;
  return m->p3d_valid[pid];
}

int32_t ms_track_len(void* h, int64_t pid) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (pid < 0 || pid >= static_cast<int64_t>(m->tracks.size())) return 0;
  return m->p3d_track_len[pid];
}

int64_t ms_point3D_of(void* h, int64_t p2d) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (p2d < 0 || p2d >= static_cast<int64_t>(m->p2d_point3D.size()))
    return -1;
  return m->p2d_point3D[p2d];
}

void ms_delete_point3D(void* h, int64_t pid) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (!pid_ok(m, pid)) return;
  for (int64_t p2d : m->tracks[pid].obs) m->p2d_point3D[p2d] = -1;
  m->tracks[pid] = Track();
  m->p3d_valid[pid] = 0;
  m->p3d_tri[pid] = 0;
  m->p3d_track_len[pid] = 0;
}

// Copy the track's point2D ids into out (caller sizes via ms_track_len).
void ms_get_track(void* h, int64_t pid, int64_t* out) {
  auto* m = static_cast<MapStoreCore*>(h);
  if (!pid_ok(m, pid)) return;
  const auto& obs = m->tracks[pid].obs;
  std::memcpy(out, obs.data(), obs.size() * sizeof(int64_t));
}

// Bulk export of point2D -> point3D (for vectorized numpy consumers).
void ms_export_p2d_point3D(void* h, int64_t* out) {
  auto* m = static_cast<MapStoreCore*>(h);
  std::memcpy(out, m->p2d_point3D.data(),
              m->p2d_point3D.size() * sizeof(int64_t));
}

void ms_export_p3d_flags(void* h, uint8_t* valid, uint8_t* tri,
                         int32_t* track_len) {
  auto* m = static_cast<MapStoreCore*>(h);
  std::memcpy(valid, m->p3d_valid.data(), m->p3d_valid.size());
  std::memcpy(tri, m->p3d_tri.data(), m->p3d_tri.size());
  std::memcpy(track_len, m->p3d_track_len.data(),
              m->p3d_track_len.size() * sizeof(int32_t));
}

// Bulk correspondence ingestion: pairs (a[i], b[i]) processed in order.
// Returns number processed; out_pids[i] = surviving pid per pair.
int64_t ms_add_correspondences(void* h, const int64_t* a, const int64_t* b,
                               int64_t n, int64_t* out_pids) {
  for (int64_t i = 0; i < n; ++i) {
    out_pids[i] = ms_add_correspondence(h, a[i], b[i]);
  }
  return n;
}

// Restore a checkpoint's tracks under their own point3D ids, into a core
// that has its images but no tracks yet: n_p3d point3D slots with the
// triangulated flags tri[0, n_p3d), all invalid, then track i =
// flat[off_i, off_i + lens[i]) at pids[i], valid. Every id is checked before anything is written;
// returns n_tracks, or -1 (core untouched) on an id out of range, a pid
// given twice or a core that already holds tracks.
int64_t ms_load_tracks(void* h, int64_t n_p3d, int64_t n_tracks,
                       const int64_t* pids, const int64_t* lens,
                       const int64_t* flat, const uint8_t* tri) {
  auto* m = static_cast<MapStoreCore*>(h);
  const int64_t n2d = static_cast<int64_t>(m->p2d_point3D.size());
  if (!m->tracks.empty() || n_p3d < 0 || n_tracks < 0) return -1;
  std::vector<uint8_t> seen(static_cast<size_t>(n_p3d), 0);
  int64_t off = 0;
  for (int64_t i = 0; i < n_tracks; ++i) {
    if (pids[i] < 0 || pids[i] >= n_p3d || seen[pids[i]] || lens[i] < 0) return -1;
    seen[pids[i]] = 1;
    for (int64_t k = off; k < off + lens[i]; ++k)
      if (flat[k] < 0 || flat[k] >= n2d) return -1;
    off += lens[i];
  }
  m->tracks.assign(static_cast<size_t>(n_p3d), Track());
  m->p3d_valid.assign(static_cast<size_t>(n_p3d), 0);
  m->p3d_tri.assign(tri, tri + n_p3d);
  m->p3d_track_len.assign(static_cast<size_t>(n_p3d), 0);
  off = 0;
  for (int64_t i = 0; i < n_tracks; ++i) {
    const int64_t pid = pids[i];
    Track& t = m->tracks[pid];
    for (int64_t k = off; k < off + lens[i]; ++k) {
      t.obs.push_back(flat[k]);
      t.imgs.insert(m->p2d_image[flat[k]]);
      m->p2d_point3D[flat[k]] = pid;
    }
    off += lens[i];
    m->p3d_valid[pid] = 1;
    m->p3d_track_len[pid] = static_cast<int32_t>(t.obs.size());
  }
  return n_tracks;
}

}  // extern "C"
