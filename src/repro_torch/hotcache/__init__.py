"""hotcache: the host tier of the hot-row cache (table, policy, miss_path).
The device cache and kernels K3/K4 wait for a later slice of the port."""
