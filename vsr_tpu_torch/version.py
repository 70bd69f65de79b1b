__version__ = "0.1.0"

# Reference capability target: YaoFANGUK/video-subtitle-remover v1.4.0
REFERENCE_VERSION = "1.4.0"
