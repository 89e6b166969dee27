"""Swarm layer of the port: the keyframe container and the front-end cameras."""
