"""Version constants (reference version/version.go: TMCoreSemVer, block
protocol 11, p2p protocol 8)."""

TMCORE_SEM_VER = "0.34.24-tpu.2"
BLOCK_PROTOCOL_VERSION = 11
P2P_PROTOCOL_VERSION = 8
