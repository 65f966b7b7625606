"""setup_s: process start to the window's start (host clock): torch and
CUDA, the program's modules, the kernels built or loaded, the nav file
parsed, the warm-up job."""


def read(obs):
    return obs.setup_s
