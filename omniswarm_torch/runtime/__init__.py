"""The node's runtime: the host's native libraries, the UDP multicast bus,
the production node (``run_node``) and the one-drone process
(``drone_process``)."""
