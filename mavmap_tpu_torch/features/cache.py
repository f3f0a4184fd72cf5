"""On-disk feature cache with parameter-change invalidation.

Port of mavmap_tpu/features/cache.py (reference
src/base2d/feature_cache.{h,cc}): one `<name>.npz` per image holding
keypoints, descriptors and image dims, with a JSON fingerprint of the
detection parameters checked on every query (a change re-extracts, as the
reference's `-params.ini` does); extract-on-miss through a detector
callback. The npz format is the JAX package's, so either package reads the
other's cache.

Two faults of the JAX version are repaired here:
  - read_reference_features reads the descriptor dump's rows/cols as the
    4-byte ints that cv::Mat writes (the JAX version reads 8 bytes each,
    so real reference dumps do not parse there);
  - ReferenceCacheProvider keeps at most `cache_capacity` images (the JAX
    version's cache grows without bound).
"""

import hashlib
import json
import os
from collections import OrderedDict

import numpy as np

from ..utils.timer import owner_counters, span
from .provider import Features


class FeatureCache:
    def __init__(self, cache_path, params: dict, detector=None, capacity=4096, totals=None):
        """detector: callable(image_idx) -> (keypoints (N,2), descriptors
        (N,D)[, (rows, cols)]). `params` is the full detection-parameter
        dict; any change invalidates previously cached entries. Each npz
        written after an extraction is the span `features.cache_write`: its
        seconds go to the counter `feature_cache_write_s` of the mapper
        whose span is open, else of `totals` (none kept where it is None),
        which several threads may share."""
        self.cache_path = cache_path
        self.detector = detector
        self.capacity = capacity
        self.totals = totals
        os.makedirs(cache_path, exist_ok=True)
        blob = json.dumps(params, sort_keys=True).encode()
        self.fingerprint = hashlib.sha256(blob).hexdigest()[:16]
        self._dims_cache = {}

    def _file(self, name):
        return os.path.join(self.cache_path, f"{name}.npz")

    def query(self, image_idx, name):
        """Features for image `name`: read on a hit, extracted on a miss."""
        path = self._file(name)
        if os.path.exists(path):
            with np.load(path) as data:
                if str(data.get("fingerprint")) == self.fingerprint:
                    return Features.from_arrays(data["keypoints"], data["descriptors"],
                                                self.capacity)
        if self.detector is None:
            raise FileNotFoundError(f"no cached features for {name} and no detector configured")
        out = self.detector(image_idx)
        kp, desc = out[0], out[1]
        dims = out[2] if len(out) > 2 else (0, 0)
        # Written under a name of this process, then renamed: ranks that
        # extract the same image at once never read half a file.
        tmp = f"{path[:-len('.npz')]}.{os.getpid()}.tmp.npz"
        with span("features.cache_write", "feature_cache_write_s",
                  totals=owner_counters(self.totals)):
            np.savez(tmp, keypoints=np.asarray(kp, np.float32),
                     descriptors=np.asarray(desc, np.float32), dims=np.asarray(dims, np.int32),
                     fingerprint=self.fingerprint)
            os.replace(tmp, path)
        return Features.from_arrays(kp, desc, self.capacity)

    def query_dimensions(self, image_idx, name):
        """(rows, cols, diagonal) of an image without decoding it (reference
        FeatureCache::query_dimensions, feature_cache.cc:168-195,222-243):
        the dims are stored with the features at extraction. (0, 0, 0.0)
        when unknown."""
        if name in self._dims_cache:
            return self._dims_cache[name]
        path = self._file(name)
        if not os.path.exists(path):
            self.query(image_idx, name)
        with np.load(path) as data:
            if "dims" not in data:
                out = (0, 0, 0.0)
            else:
                rows, cols = (int(v) for v in data["dims"])
                out = (rows, cols, float(np.hypot(rows, cols)))
        self._dims_cache[name] = out
        return out

    def clear(self):
        for f in os.listdir(self.cache_path):
            if f.endswith(".npz"):
                os.remove(os.path.join(self.cache_path, f))


# cv::KeyPoint memory layout (x, y, size, angle, response all float32;
# octave, class_id int32), 28 bytes, written raw by the reference
# (feature_cache.cc:126-131).
_CV_KEYPOINT = np.dtype([("x", "<f4"), ("y", "<f4"), ("size", "<f4"), ("angle", "<f4"),
                         ("response", "<f4"), ("octave", "<i4"), ("class_id", "<i4")])
# cv::Mat type codes the reference can emit for descriptors.
_CV_DTYPES = {0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16, 4: np.int32, 5: np.float32,
              6: np.float64}


def read_reference_features(kp_path, desc_path):
    """One image's features from the reference mavmap's binary cache dumps
    (`<name>-keypoints.bin` / `<name>-descriptors.bin`, feature_cache.cc:
    125-142 write / :145-163 read). The descriptor header is the byte count
    (size_t), then cv::Mat's rows, cols and type, each a 4-byte int.

    Returns (keypoints (N, 2) f32, descriptors (N, D) f32, responses (N,)
    f32); integer descriptor types are converted to f32 unscaled."""
    with open(kp_path, "rb") as f:
        (n_bytes,) = np.frombuffer(f.read(8), "<u8")
        raw = np.frombuffer(f.read(int(n_bytes)), _CV_KEYPOINT)
    with open(desc_path, "rb") as f:
        hdr = f.read(8 + 3 * 4)
        if len(hdr) != 20:
            raise ValueError(f"{desc_path}: descriptor header ends early")
        n_bytes = int(np.frombuffer(hdr[0:8], "<u8")[0])
        rows, cols, cv_type = (int(v) for v in np.frombuffer(hdr[8:20], "<i4"))
        depth, channels = cv_type & 7, (cv_type >> 3) + 1
        dt = _CV_DTYPES[depth]
        body = f.read(n_bytes)
        if len(body) != n_bytes or n_bytes != rows * cols * channels * np.dtype(dt).itemsize:
            raise ValueError(f"{desc_path}: {len(body)} descriptor bytes for a {rows}x{cols}x"
                             f"{channels} matrix of {np.dtype(dt).name}")
        desc = np.frombuffer(body, dt).reshape(rows, cols * channels)
    if rows != len(raw):
        raise ValueError(f"keypoint/descriptor count mismatch: {len(raw)} vs {rows}")
    kp = np.stack([raw["x"], raw["y"]], axis=-1).astype(np.float32)
    return kp, desc.astype(np.float32), raw["response"].astype(np.float32)


class ReferenceCacheProvider:
    """FeatureProvider over a directory of the reference mavmap's feature
    cache (real OpenCV-SURF features for cross-validation). Over-capacity
    images keep the strongest-response keypoints, as the reference's
    detector budget keeps its strongest maxima. At most `cache_capacity`
    images stay parsed in memory (least recently used out first).

    Each read of a frame's dumps (a miss) is the span `features.read`: its
    seconds go to the counter `feature_read_s` and one to `feature_reads`,
    of the mapper whose span is open, else of `totals` (default: a dict of
    the provider's own)."""

    def __init__(self, cache_path, names, capacity=1024, cache_capacity=256, totals=None):
        self.cache_path = cache_path
        self.names = list(names)
        self.capacity = capacity
        self.cache_capacity = cache_capacity
        self.descriptor_dim = None
        self.totals = {} if totals is None else totals
        self._cache = OrderedDict()

    def get(self, image_idx):
        if image_idx in self._cache:
            self._cache.move_to_end(image_idx)
            return self._cache[image_idx]
        name = self.names[image_idx]
        sink = owner_counters(self.totals)
        with span("features.read", "feature_read_s", totals=sink):
            kp, desc, resp = read_reference_features(
                os.path.join(self.cache_path, f"{name}-keypoints.bin"),
                os.path.join(self.cache_path, f"{name}-descriptors.bin"))
            if len(kp) > self.capacity:
                keep = np.argsort(-resp)[: self.capacity]
                keep.sort()  # keep the spatial order
                kp, desc = kp[keep], desc[keep]
            feats = Features.from_arrays(kp, desc, self.capacity)
        sink["feature_reads"] = sink.get("feature_reads", 0) + 1
        self.descriptor_dim = desc.shape[1]
        self._cache[image_idx] = feats
        if len(self._cache) > self.cache_capacity:
            self._cache.popitem(last=False)
        return feats
