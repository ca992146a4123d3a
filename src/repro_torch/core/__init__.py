"""Camel core of the port: Thompson-sampling configuration search, arm
spaces, cost metrics, the CamelTS policy and the online controller."""
