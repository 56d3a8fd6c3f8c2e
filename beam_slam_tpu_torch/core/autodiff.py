"""One lock for PyTorch's forward-mode autodiff.

``torch.func.jacfwd`` and ``jvp`` enter a forward-AD level, and PyTorch
keeps those levels in one table for the whole process, not per thread: two
threads inside forward AD at once break each other's levels ("no level
exists"). The smoother's async tick runs the LM solve's linearization
(``core/factors``) on a worker thread while the caller's thread registers
scans (``lidar/registration``) and samples trajectories (``utils/sim``), all
three through forward AD. Every forward-AD call of the port therefore runs
under :data:`FORWARD_AD`. Each such call is one linearization, a few
milliseconds of host dispatch, so the threads interleave at that grain.
"""

import threading

FORWARD_AD = threading.RLock()
