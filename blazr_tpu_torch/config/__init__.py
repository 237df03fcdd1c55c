from .app import AppConfig, parse_dtype
from .generation import GenerationConfig
from .inference import InferenceConfig, SpeculativeDecodingConfig
from .model_config import AttentionConfig, RopeScaling, UniversalConfig
from .server import LatencySlo, ServerConfig
from .user import UserConfig, user_config_path

__all__ = [
    "AppConfig",
    "AttentionConfig",
    "GenerationConfig",
    "InferenceConfig",
    "LatencySlo",
    "RopeScaling",
    "ServerConfig",
    "SpeculativeDecodingConfig",
    "UniversalConfig",
    "UserConfig",
    "parse_dtype",
    "user_config_path",
]
