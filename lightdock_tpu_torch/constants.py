"""Algorithm constants of the port.

Copy of ``lightdock_tpu/constants.py``, held equal to it by
``tests/test_torch_host.py``.  Values mirror the reference implementation's
src/constants.rs:1-28 and the GSO hyper-parameters hardcoded at glowworm
construction (reference src/glowworm.rs:45-51) so that trajectories are
comparable run-for-run.
"""

DEFAULT_SEED = 324_324

# Interpolation step sizes used by the movement phase.
DEFAULT_TRANSLATION_STEP = 0.5
DEFAULT_ROTATION_STEP = 0.5
DEFAULT_NMODES_STEP = 0.5

# SLERP falls back to normalized linear interpolation above this dot product.
LINEAR_THRESHOLD = 0.9995

# Two atoms are "in contact" (interface) below this distance (Angstrom).
INTERFACE_CUTOFF = 3.9
INTERFACE_CUTOFF2 = INTERFACE_CUTOFF * INTERFACE_CUTOFF

DEFAULT_LIGHTDOCK_PREFIX = "lightdock_"

MEMBRANE_PENALTY_SCORE = 999.0

DEFAULT_REC_NM_FILE = "rec_nm.npy"
DEFAULT_LIG_NM_FILE = "lig_nm.npy"

# GSO hyper-parameters (reference src/glowworm.rs:45-51).
GSO_RHO = 0.5
GSO_GAMMA = 0.4
GSO_BETA = 0.08
GSO_INITIAL_LUCIFERIN = 5.0
GSO_INITIAL_VISION_RANGE = 0.2
GSO_MAX_VISION_RANGE = 5.0
GSO_MAX_NEIGHBORS = 5

# DFIRE scoring (reference src/dfire.rs:334-347).
DFIRE_DIST_CUTOFF2 = 225.0   # 15 A squared
DFIRE_SCALE = 0.0157
DFIRE_OFFSET = 4.7
DFIRE_NUM_ATOM_TYPES = 169
DFIRE_NUM_BINS = 20          # nominal table stride; lookups may spill past it
DFIRE_EFFECTIVE_BINS = 32    # max value in DIST_TO_BINS (bin index <= 31)

# DNA / PYDOCK scoring (reference src/dna.rs:15-25, src/pydock.rs:17-27).
EPSILON = 4.0
FACTOR = 332.0
MAX_ES_CUTOFF = 1.0
MIN_ES_CUTOFF = -1.0
VDW_CUTOFF = 1.0
ELEC_DIST_CUTOFF = 30.0
ELEC_DIST_CUTOFF2 = ELEC_DIST_CUTOFF * ELEC_DIST_CUTOFF
VDW_DIST_CUTOFF = 10.0
VDW_DIST_CUTOFF2 = VDW_DIST_CUTOFF * VDW_DIST_CUTOFF
ELEC_MAX_CUTOFF = MAX_ES_CUTOFF * EPSILON / FACTOR
ELEC_MIN_CUTOFF = MIN_ES_CUTOFF * EPSILON / FACTOR
