"""Base layer of the port: errors, params, the Threefry stream, the random
context, matmul precision, and the device policy."""
