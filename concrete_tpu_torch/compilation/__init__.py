from concrete_tpu_torch.compilation.configuration import Configuration
from concrete_tpu_torch.compilation.compiler import Compiler, circuit, compiler
from concrete_tpu_torch.compilation.circuit import Circuit
from concrete_tpu_torch.compilation.client import Client
from concrete_tpu_torch.compilation.evaluation_keys import EvaluationKeys
from concrete_tpu_torch.compilation.keys import Keys
from concrete_tpu_torch.compilation.server import Server
from concrete_tpu_torch.compilation.module import (FheFunction, FheModule,
                                                   ModuleCompiler, function,
                                                   module)

__all__ = ["Circuit", "Client", "Compiler", "Configuration",
           "EvaluationKeys", "Keys", "Server", "circuit", "compiler",
           "FheFunction", "FheModule", "ModuleCompiler", "function",
           "module"]
