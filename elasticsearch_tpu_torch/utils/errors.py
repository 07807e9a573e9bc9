"""Exception hierarchy mirroring the reference's.

Reference: org/elasticsearch/ElasticsearchException.java and subclasses
(ElasticsearchIllegalArgumentException.java, index/engine/
VersionConflictEngineException.java, index/mapper/MapperParsingException.java,
index/query/QueryParsingException.java, search/SearchParseException.java).
Each carries an HTTP status so the REST layer can map errors the same way
ES's RestStatus does.
"""


class ElasticsearchTpuException(Exception):
    status = 500

    @property
    def error_type(self) -> str:
        # e.g. VersionConflictException -> version_conflict_exception
        name = type(self).__name__
        out = []
        for i, ch in enumerate(name):
            if ch.isupper() and i > 0:
                out.append("_")
            out.append(ch.lower())
        return "".join(out)


class IllegalArgumentException(ElasticsearchTpuException):
    status = 400


class ActionRequestValidationException(ElasticsearchTpuException):
    """Request-level validation failures (reference:
    action/ActionRequestValidationException — 'Validation Failed: 1: ...')."""

    status = 400

    def __init__(self, *problems: str):
        msg = "Validation Failed: " + " ".join(
            f"{i + 1}: {p};" for i, p in enumerate(problems))
        super().__init__(msg)


class TypeMissingException(ElasticsearchTpuException):
    """Requested mapping type does not exist (reference:
    indices/TypeMissingException.java)."""

    status = 404

    def __init__(self, doc_type: str):
        super().__init__(f"type[[{doc_type}]] missing")


class AlreadyExpiredException(ElasticsearchTpuException):
    """Doc indexed with a TTL whose expiry is already in the past
    (reference: index/AlreadyExpiredException.java via TTLFieldMapper)."""

    status = 400

    def __init__(self, doc_id: str, timestamp: int, ttl_ms: int):
        super().__init__(
            f"already expired [{doc_id}]: timestamp [{timestamp}] + "
            f"ttl [{ttl_ms}ms] is in the past")


class IndexNotFoundException(ElasticsearchTpuException):
    status = 404

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]")
        self.index = index


class IndexAlreadyExistsException(ElasticsearchTpuException):
    status = 400

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists")
        self.index = index


class DocumentMissingException(ElasticsearchTpuException):
    status = 404

    def __init__(self, index: str, doc_id: str):
        super().__init__(f"[{index}][{doc_id}]: document missing")
        self.index = index
        self.doc_id = doc_id


class VersionConflictException(ElasticsearchTpuException):
    status = 409

    def __init__(self, index: str, doc_id: str, current: int, expected: int):
        super().__init__(
            f"[{index}][{doc_id}]: version conflict, current version [{current}] "
            f"is different than the one provided [{expected}]"
        )
        self.current = current
        self.expected = expected


class MapperParsingException(ElasticsearchTpuException):
    status = 400


class QueryParsingException(ElasticsearchTpuException):
    status = 400


class SearchParseException(ElasticsearchTpuException):
    status = 400


class RoutingMissingException(ElasticsearchTpuException):
    """Reference: action/RoutingMissingException.java — a type with a
    `_parent` mapping (or `_routing required`) was written/read without
    the routing/parent that places it on a shard."""

    status = 400

    def __init__(self, index: str, doc_type: str, doc_id: str):
        super().__init__(
            f"routing is required for [{index}]/[{doc_type}]/[{doc_id}]")


class SearchContextMissingException(ElasticsearchTpuException):
    """Reference: search/SearchContextMissingException.java — a scroll id
    that no longer has a live context (expired or cleared) is a 404."""

    status = 404


class ScriptException(ElasticsearchTpuException):
    status = 400


class TaskCancelledException(ElasticsearchTpuException):
    """Raised at a cooperative checkpoint of a cancelled task (reference:
    tasks/TaskCancelledException.java); 400, as the reference maps it."""

    status = 400


class EngineFailedException(ElasticsearchTpuException):
    """Reference: index/engine/EngineClosedException + the tragic-event
    path of InternalEngine.failEngine — a durability-critical IO failure
    (translog write/fsync) fails the engine CLOSED: every subsequent
    write is rejected with a 503 instead of being acknowledged against a
    log that can no longer persist it."""

    status = 503

    def __init__(self, index: str, reason: str):
        super().__init__(
            f"engine for [{index or '_na_'}] has failed: {reason}")
        self.index = index
        self.reason = reason


class StalePrimaryException(ElasticsearchTpuException):
    """An op carried a primary term older than the receiving copy's
    current term: the sender was demoted (node death → reroute promoted
    another in-sync copy) but doesn't know it yet. Rejecting with a typed
    conflict closes the zombie-primary window — a demoted primary can
    never silently ack a write its replacement will not have. Reference:
    the seq-no era's operation-primary-term fencing in
    TransportReplicationAction / InternalEngine (IndexShard asserts
    opPrimaryTerm <= pendingPrimaryTerm and fails the op otherwise)."""

    status = 409

    def __init__(self, index: str, shard_id: object, op_term: int,
                 current_term: int):
        super().__init__(
            f"[{index or '_na_'}][{shard_id}]: op with primary term "
            f"[{op_term}] is stale, current term is [{current_term}]")
        self.index = index
        self.shard_id = shard_id
        self.op_term = op_term
        self.current_term = current_term


class ClusterBlockException(ElasticsearchTpuException):
    """Reference: cluster/block/ClusterBlockException.java — the op hit a
    cluster-level block. The one mattering here is the NO_MASTER_BLOCK
    (write level): with no elected master, metadata changes and writes are
    rejected 503 while searches keep serving the last committed state —
    an unquorate minority must fail loudly, never ack into a state the
    majority will not have."""

    status = 503

    def __init__(self, blocks):
        self.blocks = list(blocks)
        desc = ", ".join(
            f"[SERVICE_UNAVAILABLE/{b.get('id', '?')}/"
            f"{b.get('description', '')}]" for b in self.blocks)
        super().__init__(f"blocked by: {desc};")


class StaleMasterException(ElasticsearchTpuException):
    """A cluster-state publication carried a term older than this node's
    current term: the publisher lost an election it doesn't know about
    yet (partitioned old master). Rejecting with a typed 409 mirrors the
    data plane's StalePrimaryException fence — a superseded master can
    never commit a state the quorum's real master will not have.
    Reference: the coordination-era PublicationTransportHandler rejecting
    publish requests below the current term."""

    status = 409

    def __init__(self, publisher: str, publish_term: int,
                 current_term: int):
        super().__init__(
            f"publication from [{publisher}] with term [{publish_term}] "
            f"is stale, current term is [{current_term}]")
        self.publisher = publisher
        self.publish_term = publish_term
        self.current_term = current_term


class FailedToCommitClusterStateException(ElasticsearchTpuException):
    """Reference: cluster/coordination FailedToCommitClusterStateException
    — the master could not gather a quorum of publish acks, so the state
    change was NOT committed and the master steps down rather than
    split-braining. The driving metadata op fails typed instead of
    acking a change the majority never saw."""

    status = 503


class CircuitBreakingException(ElasticsearchTpuException):
    """Reference: org/elasticsearch/common/breaker/CircuitBreaker.java —
    a memory budget would be exceeded; the REQUEST fails (429-style), the
    node survives. ``bytes_wanted``/``bytes_limit`` mirror the reference
    exception's fields (resources/breakers.py fills them)."""

    status = 429

    def __init__(self, *args, bytes_wanted: int = 0, bytes_limit: int = 0):
        super().__init__(*args)
        self.bytes_wanted = bytes_wanted
        self.bytes_limit = bytes_limit
