"""The port's host-side native code (C++ with a C interface, built at first
use with the host compiler and loaded with ctypes): the shard compiler's
loops, ``shardops``."""
