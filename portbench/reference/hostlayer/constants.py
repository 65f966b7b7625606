"""Physical and ICD constants for the Galileo E1 OS signal.

Values mirror the reference simulator's configuration
(reference: include/constants.h) so that generated scenarios are
behaviourally interchangeable.  All are plain Python floats/ints usable
inside and outside of jit.
"""

# --- time ------------------------------------------------------------
SECONDS_IN_WEEK = 604800.0
SECONDS_IN_HALF_WEEK = 302400.0
SECONDS_IN_DAY = 86400.0
SECONDS_IN_HOUR = 3600.0
SECONDS_IN_MINUTE = 60.0

# --- WGS-84 / dynamics (constants.h:59-62,99-101) --------------------
WGS84_RADIUS = 6378137.0
WGS84_ECCENTRICITY = 0.0818191908426
SPEED_OF_LIGHT = 2.99792458e8
GM_EARTH = 3.986005e14
WGS_SQRT_GM = 19964981.8432173887
OMEGA_EARTH = 7.2921151467e-5

# --- E1 signal (constants.h:66-128, 156) -----------------------------
CARR_FREQ = 1575.42e6  # Galileo E1 carrier [Hz]
LAMBDA_E1 = 0.1902936727983649  # E1 carrier wavelength [m]
LAMBDA_L1 = 0.190293672798365  # GPS L1 value the reference uses for phase init
CA_SEQ_LEN_E1 = 4092  # E1B/E1C primary code length [chips]
CODE_FREQ_E1 = 1.023e6  # chip rate [Hz]
CARR_TO_CODE_E1 = 0.0006493506493506494  # 1/1540: carrier Doppler -> code Doppler
BOC_SEQ_LEN_E1 = 2 * CA_SEQ_LEN_E1  # 8184 half-chips after BOC(1,1)

# --- navigation message (constants.h:31-48) --------------------------
N_BIT_PAGE = 120  # I/NAV half-page bits fed to the FEC
N_SYM_PAGE = 500  # symbols per 2 s page pair
PAGE_SIZE = 500
PAGE_TRANS_TIME = 2  # seconds per page pair
SYMBOL_TIME_MS = 4  # 1 symbol = 1 primary code period = 4 ms

# --- simulator configuration (constants.h:10,74-108) -----------------
SAMP_RATE = 2.6e6  # output sample rate [sps]
TX_FREQUENCY = 1575.42e6
NUM_IQ_SAMPLES = int(SAMP_RATE / 10)  # samples per 0.1 s epoch block (260000)
FIFO_LENGTH = NUM_IQ_SAMPLES * 2
SAMPLES_PER_BUFFER = 32768
MAX_CHAN = 16  # simultaneous satellite channels
MAX_SAT = 36  # PRNs considered by the scenario engine
N_PRN_CODES = 50  # code sets available in the ICD tables
EPHEM_ARRAY_SIZE = 100

# Reference's epoch-loop time step: intentionally not exactly 0.1 s
# (galileo-sdr.cpp:347); kept for behavioural parity.
EPOCH_DT = 0.10000002314200000
EPOCH_SAMPLES = NUM_IQ_SAMPLES

# Amplitude of the reference sin/cos LUT (constants.h:218).
LUT_AMPLITUDE = 250

# --- misc ------------------------------------------------------------
R2D = 57.2957795131
GNSS_PI = 3.1415926535898
D2R = GNSS_PI / 180.0

# NeQuick-G (constants.h:195-206)
NEQUICK_ZENITH0 = 86.23292796211615
NEQUICK_RE_KM = 6371.2
NEQUICK_MAX_RECURSION = 50

# I/NAV word-type transmission schedule over a 30-slot (60 s) cycle
# (reference: include/galileo-sdr.h:32-35); slot = (int(tow) % 60) / 2.
WORD_ALLOCATION_E1 = (
    2, 4, 6, 7, 8, 17, 19, 16, 0, 0, 1, 3, 5, 0, 16,
    2, 4, 6, 9, 10, 17, 19, 16, 0, 0, 1, 3, 5, 0, 16,
)
