"""Framework constants the port's paths need (the subset of
invesalius3_tpu/constants.py that the port uses; values equal, as the tests
check): orientations, projection ids, mask voxel codes, mask boolean ops,
image filter ids, brush shapes and editor ops, threshold presets, surface
quality presets, the hole-filling cap, the .inv3 format version, the
mask undo depth and the reslice interpolation ids.
"""

from __future__ import annotations

# Orientations (axis 0 = Z, 1 = Y, 2 = X of a (Z, Y, X) volume)
AXIAL = "AXIAL"
CORONAL = "CORONAL"
SAGITTAL = "SAGITTAL"
ORIENTATION_AXIS = {AXIAL: 0, CORONAL: 1, SAGITTAL: 2}

# Slab projection types (reference constants.py:803-815)
PROJECTION_NORMAL = 0
PROJECTION_MaxIP = 1
PROJECTION_MinIP = 2
PROJECTION_MeanIP = 3
PROJECTION_LMIP = 4
PROJECTION_MIDA = 5
PROJECTION_CONTOUR_MIP = 6
PROJECTION_CONTOUR_LMIP = 7
PROJECTION_CONTOUR_MIDA = 8

PROJECTION_NAMES = {
    PROJECTION_NORMAL: "Normal",
    PROJECTION_MaxIP: "MaxIP",
    PROJECTION_MinIP: "MinIP",
    PROJECTION_MeanIP: "MeanIP",
    PROJECTION_LMIP: "LMIP",
    PROJECTION_MIDA: "MIDA",
    PROJECTION_CONTOUR_MIP: "Contour MaxIP",
    PROJECTION_CONTOUR_LMIP: "Contour LMIP",
    PROJECTION_CONTOUR_MIDA: "Contour MIDA",
}

# Mask voxel codes (uint8): 0 background, 255 inside the threshold, 1/2
# erased and 253/254 painted by the editor (these survive a re-threshold);
# voxels >= 127 are "visible".
MASK_BACKGROUND = 0
MASK_ERASED = 1
MASK_ERASED_ALT = 2
MASK_PAINTED = 253
MASK_FILLED = 254
MASK_THRESHOLD_IN = 255
MASK_EDIT_CODES = (1, 2, 253, 254)
MASK_VISIBLE_MIN = 127

# Mask boolean operations (reference constants.py:818-821, slice_.py:1878)
BOOLEAN_UNION = 1
BOOLEAN_DIFF = 2
BOOLEAN_AND = 3
BOOLEAN_XOR = 4
BOOLEAN_OP_NAMES = {
    BOOLEAN_UNION: "Union",
    BOOLEAN_DIFF: "Diff",
    BOOLEAN_AND: "Intersection",
    BOOLEAN_XOR: "XOR",
}

# Image filters producing selectable image versions (reference
# data/filters.py, slice_.py __apply_image_filter)
FILTER_GAUSSIAN = 0
FILTER_MEDIAN = 1
FILTER_MEAN = 2
FILTER_SHARPEN = 3
FILTER_DESPECKLE = 4
FILTER_BORDER = 5
FILTER_NAMES = {
    FILTER_GAUSSIAN: "gaussian",
    FILTER_MEDIAN: "median",
    FILTER_MEAN: "mean",
    FILTER_SHARPEN: "sharpen",
    FILTER_DESPECKLE: "despeckle",
    FILTER_BORDER: "sobel",
}

# Brush shapes and editor operations (reference styles.py EditorConfig)
BRUSH_CIRCLE = "circle"
BRUSH_SQUARE = "square"

BRUSH_DRAW = 0
BRUSH_ERASE = 1
BRUSH_THRESHOLD = 2

# CT threshold presets (Hounsfield; semantics of reference presets.py)
THRESHOLD_PRESETS_CT = {
    "Bone": (226, 3071),
    "Compact Bone (Adult)": (662, 1988),
    "Compact Bone (Child)": (586, 2198),
    "Spongial Bone (Adult)": (148, 661),
    "Spongial Bone (Child)": (156, 585),
    "Enamel (Adult)": (1553, 2850),
    "Enamel (Child)": (2042, 3071),
    "Fat Tissue (Adult)": (-205, -51),
    "Fat Tissue (Child)": (-212, -72),
    "Muscle Tissue (Adult)": (-5, 135),
    "Muscle Tissue (Child)": (-25, 139),
    "Skin Tissue (Adult)": (-718, -177),
    "Skin Tissue (Child)": (-766, -202),
    "Soft Tissue": (-700, 225),
    "Custom": (0, 0),
}

THRESHOLD_PRESETS_OTHER = {
    "Bone": (200, 1500),
    "Soft Tissue": (-300, 100),
    "Custom": (0, 0),
}

# Surface quality presets: (image_spacing_scale, smooth_iterations,
# smooth_relaxation, decimate_reduction) (reference constants.py:359-364)
SURFACE_QUALITY = {
    "Low": (3, 2, 0.3000, 0.4),
    "Medium": (2, 2, 0.3000, 0.4),
    "High": (0, 1, 0.3000, 0.1),
    "Optimal *": (0, 2, 0.3000, 0.0),
}

DEFAULT_SURFACE_QUALITY = "Optimal *"

# Surface post-processing defaults (reference surface_process.py:397-415)
FILL_HOLES_MAX_SIZE = 300.0

# Project file format (reference constants.py:32)
INV3_FORMAT_VERSION = 1.1

# Mask undo-history depth (reference mask.py:79)
MASK_HISTORY_SIZE = 50

# Reslice interpolation methods (reference constants.py; ops/reslice.py)
INTERP_NEAREST = 0
INTERP_TRILINEAR = 1
INTERP_TRICUBIC = 2
INTERP_LANCZOS = 3

# Watershed algorithms (reference watershed_process.py:19-61)
WATERSHED = "Watershed"
WATERSHED_IFT = "Watershed (IFT)"

# Deep-learning patch defaults (reference segment.py:27,74)
DL_PATCH_SIZE = 48
DL_PATCH_OVERLAP = 0.5

# Navigation loop pacing (reference navigation.py:146-152, coregistration.py:363)
NAV_POLL_HZ = 120.0
NAV_RENDER_MAX_HZ = 100.0
NAV_SLICE_RENDER_MAX_HZ = 10.0
