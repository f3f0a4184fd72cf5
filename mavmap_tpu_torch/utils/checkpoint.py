"""Map-state checkpoint / resume.

Port of mavmap_tpu/utils/checkpoint.py: full save and restore of a
SequentialMapper's reconstruction (poses, points, tracks, pair graph) and of
its loop detector's per-image quantizations, so a long run survives
preemption. One .npz per checkpoint, in the JAX package's format: a map
saved by either package loads in the other.
"""

import json

import numpy as np


def save_map(mapper, path):
    """Serialize a SequentialMapper's reconstruction state to `path` (npz)."""
    mapper.flush_ba()
    s = mapper.store
    track_pids = list(s.tracks.keys())
    track_flat = (np.concatenate([np.asarray(s.tracks[p], np.int64) for p in track_pids])
                  if track_pids else np.zeros(0, np.int64))
    track_lens = np.asarray([len(s.tracks[p]) for p in track_pids], np.int64)

    # Loop-detector persistence (the reference's idf save/load,
    # voc_tree_inv_file.cc:331-344): the per-image quantizations rebuild the
    # retrieval database on load without a vocabulary-tree descent.
    loop_kw = {}
    det = getattr(mapper, "loop_detector", None)
    if det is not None:
        idxs, words = det.saved_words()
        loop_kw["loop_idxs"] = np.asarray(idxs, np.int64)
        loop_kw["loop_words_lens"] = np.asarray([len(words[i]) for i in idxs], np.int64)
        loop_kw["loop_words_flat"] = (
            np.concatenate([np.asarray(words[i], np.int64) for i in idxs])
            if idxs else np.zeros(0, np.int64))

    np.savez_compressed(
        path, **loop_kw,
        camera_params=s.camera_params, camera_models=s.camera_models,
        image_rvecs=s.image_rvecs, image_tvecs=s.image_tvecs, image_cameras=s.image_cameras,
        image_registered=s.image_registered, point2D_xy=s.point2D_xy,
        point2D_xy_norm=s.point2D_xy_norm, point2D_image=s.point2D_image,
        point2D_point3D=s.point2D_point3D,
        image_point2D_start=np.asarray(s.image_point2D_start, np.int64),
        point3D_xyz=s.point3D_xyz, point3D_valid=s.point3D_valid, point3D_tri=s.point3D_tri,
        point3D_error=s.point3D_error, point3D_fixed=s.point3D_fixed,
        point3D_track_len=s.point3D_track_len,
        track_pids=np.asarray(track_pids, np.int64), track_flat=track_flat,
        track_lens=track_lens,
        idx_to_id=json.dumps({int(k): int(v) for k, v in mapper.image_idx_to_id.items()}),
        pair_graph=np.asarray(sorted(mapper.pair_graph), np.int64).reshape(-1, 2),
        num_proc_images=mapper.num_proc_images,
    )


def load_map(mapper, path):
    """Restore state saved by `save_map` into a fresh SequentialMapper
    (constructed with the same image/camera tables and provider).

    Beyond the JAX version, the mapper's camera table (dataset camera ->
    store camera) and its min/max processed image are rebuilt from the
    restored images, so an image registered after the resume shares its
    camera, and any self-calibrated intrinsics, with the images before it;
    the JAX version would add a fresh copy of the camera from the dataset's
    intrinsics."""
    d = np.load(path, allow_pickle=False)
    tracks = {}
    off = 0
    flat = d["track_flat"]
    for pid, ln in zip(d["track_pids"], d["track_lens"]):
        tracks[int(pid)] = flat[off: off + int(ln)]
        off += int(ln)
    s = mapper.store
    s.load_state(d, tracks)

    mapper.image_idx_to_id = {int(k): int(v)
                              for k, v in json.loads(str(d["idx_to_id"])).items()}
    mapper.image_id_to_idx = {v: k for k, v in mapper.image_idx_to_id.items()}
    mapper.pair_graph = set((int(a), int(b)) for a, b in d["pair_graph"])
    mapper.num_proc_images = int(d["num_proc_images"])
    for idx, iid in mapper.image_idx_to_id.items():
        cam_idx = int(mapper.image_cameras[idx])
        mapper._store_cam_ids[cam_idx] = int(s.image_cameras[iid])
        mapper.cam_params[cam_idx] = s.camera_params[int(s.image_cameras[iid])]
        mapper._track_minmax(idx)
    # Restore the loop detector: saved quantizations re-index without a
    # tree descent; images missing from the checkpoint (detector enabled
    # after the save) are quantized again.
    if mapper.loop_detector is not None:
        det = mapper.loop_detector
        if "loop_idxs" in d:
            flat = d["loop_words_flat"]
            off = 0
            for idx, ln in zip(d["loop_idxs"], d["loop_words_lens"]):
                det.restore_image(int(idx), mapper._features(int(idx)), flat[off:off + int(ln)])
                off += int(ln)
        for idx in sorted(mapper.image_idx_to_id.keys()):
            if idx not in det._idx_to_slot and idx not in det._pending:
                det.add_image(idx, mapper._features(idx))
    return mapper
