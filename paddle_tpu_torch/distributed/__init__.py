"""Distributed helpers of the port: the wire codecs of the collectives."""
