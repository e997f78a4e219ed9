"""Hand-skeleton and MANO constants (the subset of handmvnet_tpu/constants.py
that the inference path, the mesh stage and the visualisation use)."""

import numpy as np

NUM_JOINTS = 21
NUM_MANO_VERTS = 778

# 14 extra triangles that close the MANO mesh at the wrist (the released
# mesh is open there); vertex ids are a public constant from
# hassony2/handobjectconsist meshreg/models/manoutils.py, used by the
# reference visualizer (src/vis/utils.py:23-46)
MANO_CLOSED_FIST_FACES = (
    (92, 38, 122), (234, 92, 122), (239, 234, 122), (279, 239, 122),
    (215, 279, 122), (215, 122, 118), (215, 118, 117), (215, 117, 119),
    (215, 119, 120), (215, 120, 108), (215, 108, 79), (215, 79, 78),
    (215, 78, 121), (214, 215, 121),
)


def close_mano_faces(faces: np.ndarray) -> np.ndarray:
    """Append the wrist-closing triangles to a MANO face list."""
    return np.concatenate(
        [np.asarray(faces, np.int32), np.asarray(MANO_CLOSED_FIST_FACES, np.int32)]
    )


# 20 bones of the 21-joint hand skeleton (MANO & Mediapipe ordering):
# wrist=0; each finger chain root->tip
HAND_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 4),      # thumb
    (0, 5), (5, 6), (6, 7), (7, 8),      # index
    (0, 9), (9, 10), (10, 11), (11, 12),  # middle
    (0, 13), (13, 14), (14, 15), (15, 16),  # ring
    (0, 17), (17, 18), (18, 19), (19, 20),  # little
)

# RGB colors for drawing the wrist + 20 bones (reference src/constants.py:43-49)
HAND_EDGE_COLORS = (
    (1.0, 0.0, 0.0),
    (0.0, 0.4, 0.0), (0.0, 0.6, 0.0), (0.0, 0.8, 0.0), (0.0, 1.0, 0.0),
    (0.0, 0.0, 0.6), (0.0, 0.0, 1.0), (0.2, 0.2, 1.0), (0.4, 0.4, 1.0),
    (0.0, 0.4, 0.4), (0.0, 0.6, 0.6), (0.0, 0.8, 0.8), (0.0, 1.0, 1.0),
    (0.4, 0.4, 0.0), (0.6, 0.6, 0.0), (0.8, 0.8, 0.0), (1.0, 1.0, 0.0),
    (0.4, 0.0, 0.4), (0.6, 0.0, 0.6), (0.8, 0.0, 0.8), (1.0, 0.0, 1.0),
)

# Map from skeleton joint id to MANO pose-rotation slot (1..15);
# slot 0 is the global orientation
ID2ROT = {
    2: 13, 3: 14, 4: 15,
    6: 1, 7: 2, 8: 3,
    10: 4, 11: 5, 12: 6,
    14: 10, 15: 11, 16: 12,
    18: 7, 19: 8, 20: 9,
}

# Vertex indices of the five fingertips on the MANO mesh
# (manopth convention: thumb, index, middle, ring, little)
MANO_TIP_VERT_IDS = (745, 317, 444, 556, 673)

# Reordering of MANO's 16 skeletal joints + 5 appended tips into the
# 21-joint Mediapipe layout above (manopth convention)
MANO_TO_MEDIAPIPE = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)

# Mean flat-hand joint layout in millimeters, wrist at origin (a dataset
# statistic; the synthetic MANO model is built around it)
MEAN_HAND_POSE = (
    (0.0, 0.0, 0.0),
    (-24.0897, -15.5223, 25.8128),
    (-47.9622, -32.1754, 35.8481),
    (-73.3033, -40.2934, 40.9490),
    (-100.3159, -61.5661, 38.1040),
    (-88.0972, -5.2004, 20.6860),
    (-119.6257, -14.9273, 21.1797),
    (-126.9626, -35.7351, 18.7743),
    (-131.6708, -58.1070, 22.4448),
    (-94.6604, -1.4790, -3.3575),
    (-122.0285, -16.2397, -9.7004),
    (-127.5804, -38.7564, -11.6812),
    (-127.4778, -64.8121, -10.6014),
    (-81.7355, -3.9574, -26.6732),
    (-105.8523, -19.6817, -28.4313),
    (-110.0102, -44.1092, -27.8379),
    (-111.2160, -67.2454, -23.0631),
    (-68.7870, -9.9403, -43.2093),
    (-82.8804, -24.5682, -48.9638),
    (-87.7756, -42.8571, -48.2308),
    (-91.7546, -62.1284, -44.9598),
)
