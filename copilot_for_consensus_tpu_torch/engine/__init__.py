"""TPU serving engines.

The resident compute plane that replaces the reference's external
inference services (SURVEY.md §0): a continuous-batching generation
engine in the role of Ollama / llama.cpp, and a cross-text-batching
embedding engine in the role of sentence-transformers.
"""

from copilot_for_consensus_tpu_torch.engine.faults import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
from copilot_for_consensus_tpu_torch.engine.journal import (
    EngineJournal,
    JournalEntry,
)
from copilot_for_consensus_tpu_torch.engine.scheduler import (
    EngineOverloaded,
    Scheduler,
    SchedulerConfig,
    jain_index,
)
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    CircuitBreaker,
    EngineFailed,
    EngineSupervisor,
    EngineSuspect,
    SupervisorConfig,
)
from copilot_for_consensus_tpu_torch.engine.telemetry import (
    EngineTelemetry,
    FlightRecorder,
    RequestTrace,
    StepRecord,
)
from copilot_for_consensus_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    HashWordTokenizer,
    Tokenizer,
    create_tokenizer,
)

__all__ = [
    "Tokenizer",
    "ByteTokenizer",
    "HashWordTokenizer",
    "create_tokenizer",
    "EngineTelemetry",
    "FlightRecorder",
    "RequestTrace",
    "StepRecord",
    "EngineOverloaded",
    "Scheduler",
    "SchedulerConfig",
    "jain_index",
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "InjectedFault",
    "EngineJournal",
    "JournalEntry",
    "CircuitBreaker",
    "EngineFailed",
    "EngineSupervisor",
    "EngineSuspect",
    "SupervisorConfig",
]
