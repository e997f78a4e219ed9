"""The hand's constants that the reference and the benchmark's inputs use:
the 21-joint skeleton, MANO's joint order and tip vertices, and the mean
flat-hand layout the synthetic MANO model is built around."""

NUM_JOINTS = 21
NUM_MANO_VERTS = 778

# wrist, then thumb, index, middle, ring and little, four joints each
HAND_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 4),      # thumb
    (0, 5), (5, 6), (6, 7), (7, 8),      # index
    (0, 9), (9, 10), (10, 11), (11, 12),  # middle
    (0, 13), (13, 14), (14, 15), (15, 16),  # ring
    (0, 17), (17, 18), (18, 19), (19, 20),  # little
)

# MANO pose slot of each finger joint, root to tip
ID2ROT = {
    2: 13, 3: 14, 4: 15,
    6: 1, 7: 2, 8: 3,
    10: 4, 11: 5, 12: 6,
    14: 10, 15: 11, 16: 12,
    18: 7, 19: 8, 20: 9,
}

# MANO vertex ids of the fingertips: thumb, index, middle, ring, little
MANO_TIP_VERT_IDS = (745, 317, 444, 556, 673)

# MANO's 16 joints and the 5 tips, reordered into the 21-joint layout
MANO_TO_MEDIAPIPE = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)

# mean flat-hand joint layout in mm, wrist at the origin
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
